"""Multi-device example: the full pipeline sharded over a device mesh.

Columns are independent, so the only parallel decision is the batch
sharding; XLA inserts no collectives in the pipeline itself and the
adiabat tables are replicated.  Works identically on the cards of one
host (every visible device joins the mesh; run
parallel.distributed_init() first on each host of a cluster):

    python examples/multichip.py

and on a virtual CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

os.environ.setdefault(
    'XLA_FLAGS', '--xla_force_host_platform_device_count=8')


def main():
    import jax

    from demo import synthetic_dataset
    from xarray_parcel_tpu import api, parallel, pipeline

    devices = jax.devices()
    mesh = parallel.make_mesh(devices)
    print(f'mesh: {len(devices)} x {devices[0].platform}')

    tables = parallel.replicate(api.load_moist_adiabat_lookups(), mesh)
    dat = synthetic_dataset(16, L=40)
    dat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in dat.items()}
    dat = parallel.shard_batch(dat, mesh)
    print('batch sharding:', dat['pressure'].sharding)

    out = jax.jit(lambda d: pipeline.conv_properties(d, tables=tables))(dat)
    jax.block_until_ready(out)

    # The workload's only communication: cross-device validation stats.
    cnt, mean, mx = parallel.global_stats(out['mu_cape'], mesh)
    print(f'mu_cape over {int(cnt)} columns: mean={float(mean):.1f} '
          f'max={float(mx):.1f} J/kg')

    # Out-of-core + data-parallel composed: grids larger than one
    # device's HBM stream through the mesh in sharded chunks.
    host = synthetic_dataset(16, L=40)
    host = {k: v.reshape((-1,) + v.shape[2:]) for k, v in host.items()}
    streamed = parallel.stream_map(
        lambda d: pipeline.conv_properties(d, tables=tables), host,
        batch_columns=64, mesh=mesh)
    np.testing.assert_allclose(
        streamed['mu_cape'], np.asarray(out['mu_cape']), rtol=1e-5,
        atol=1e-4, equal_nan=True)
    print(f'streamed+sharded: {len(streamed)} variables match the '
          f'whole-grid sharded run')


if __name__ == '__main__':
    main()
