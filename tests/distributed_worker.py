"""One process of a multi-host (multi-process) pipeline run.

Launched by test_distributed.py, twice: each process owns 4 virtual CPU
devices and joins an 8-device GLOBAL mesh through
``parallel.distributed_init`` — the launch-side counterpart of the
reference's multi-worker dask LocalCluster
(reference: parcel_functions_demo.ipynb cell 3).  The process

* initialises ``jax.distributed`` against the shared coordinator,
* builds the global mesh over all 8 devices (``make_mesh()``),
* shards the (host-replicated) input grid over it and runs the jitted
  full pipeline — XLA places every column's work on its shard's device;
  the only cross-PROCESS communication is the psum/pmax validation
  collective, which rides the gloo backend exactly as it would ride
  ICI/DCN on a pod slice,
* asserts its OWN addressable output shards equal the corresponding
  slices of the single-process reference computed by the parent, and the
  global-stats collective equals the reference's host-side reduction.

Usage: distributed_worker.py <process_id> <num_processes> <port> <npz>
"""

import os
import sys


def main():
    pid, nproc, port, data_path = (int(sys.argv[1]), int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4])
    # 4 virtual CPU devices per process; must be set before backend init.
    flags = [f for f in os.environ.get('XLA_FLAGS', '').split()
             if 'host_platform_device_count' not in f]
    flags.append('--xla_force_host_platform_device_count=4')
    os.environ['XLA_FLAGS'] = ' '.join(flags)

    os.environ['JAX_PLATFORMS'] = 'cpu'

    import numpy as np
    import jax
    jax.config.update('jax_enable_x64', True)

    from xarray_parcel_tpu import adiabat, pipeline
    from xarray_parcel_tpu.parallel import (distributed_init, global_stats,
                                            make_mesh, replicate, shard_batch)

    distributed_init(coordinator_address=f'127.0.0.1:{port}',
                     num_processes=nproc, process_id=pid)
    n_local = len(jax.local_devices())
    n_global = len(jax.devices())
    assert n_global == nproc * n_local, (n_global, nproc, n_local)
    print(f'[worker {pid}] {n_local} local / {n_global} global devices',
          flush=True)

    with np.load(data_path) as f:
        dat = {k[3:]: f[k] for k in f.files if k.startswith('in_')}
        expect = {k[4:]: f[k] for k in f.files if k.startswith('out_')}

    mesh = make_mesh()            # GLOBAL mesh: all 8 devices, both hosts
    raw_tables = adiabat.load_moist_adiabat_lookups()
    tables = replicate(raw_tables, mesh)
    # Host-replicated numpy + a global sharding: each process places only
    # its addressable shards (the multi-host ingest contract).
    dat_sh = shard_batch(dat, mesh, batch_dims=1)

    run = jax.jit(lambda d: pipeline.conv_properties(d, tables=tables))
    out = run(dat_sh)
    jax.block_until_ready(out)

    checked = 0
    for k, ref in expect.items():
        arr = out[k]
        for s in arr.addressable_shards:
            a = np.asarray(s.data)
            b = ref[s.index]
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=f'NaN pattern: {k}')
            np.testing.assert_allclose(
                np.nan_to_num(a), np.nan_to_num(b), rtol=2e-5, atol=2e-4,
                err_msg=f'{k} shard {s.index}')
            checked += 1
    assert checked > 0

    # The cross-process collective: count/mean/max of a sharded field via
    # psum/pmax over the global mesh must equal the host-side reduction.
    cnt, mean, mx = (np.asarray(v) for v in
                     global_stats(out['mu_cape'], mesh))
    ref = expect['mu_cape']
    fin = np.isfinite(ref)
    assert int(cnt) == int(fin.sum()), (cnt, fin.sum())
    np.testing.assert_allclose(float(mean), float(ref[fin].mean()),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mx), float(ref[fin].max()), rtol=1e-6)

    print(f'[worker {pid}] OK: {checked} shards verified, '
          f'psum count={int(cnt)}', flush=True)

    # SPMD serving across processes: a mesh= artifact served on a batch
    # that does NOT fit the exported batch takes deploy's pad/chunk path,
    # whose outputs are global arrays spanning both processes — the
    # host-side materialization must gather them (Deployed._host), not
    # np.asarray a non-addressable value.  B=24 through bex=16 -> pad to
    # 32, two sharded chunks; every process ends with the full value.
    from xarray_parcel_tpu import deploy
    minref = {}
    with np.load(data_path) as f:
        minref = {k[7:]: f[k] for k in f.files if k.startswith('minout_')}
    dep = deploy.export_pipeline('min_conv_properties', batch=16,
                                 levels=dat['pressure'].shape[1],
                                 dtype=np.float64, tables=raw_tables,
                                 mesh=mesh)
    served = dep(dat, tables=raw_tables, mesh=mesh)
    for k, ref in minref.items():
        got = np.asarray(served[k])
        assert got.shape == ref.shape, (k, got.shape, ref.shape)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref),
                                      err_msg=f'NaN pattern: {k}')
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(ref),
                                   rtol=2e-5, atol=2e-4, err_msg=k)
    print(f'[worker {pid}] serving OK: {len(minref)} variables, '
          f'batch {dat["pressure"].shape[0]} through exported 16',
          flush=True)


if __name__ == '__main__':
    main()
