"""Benchmark: full conv_properties pipeline + surface CAPE/CIN on one GPU.

Prints ONE JSON line:
  metric      — full ~20-variable diagnostics pipeline throughput, the
                reference's headline benchmark (225 columns in 5.17 s
                ~= 43.5 columns/sec on its 2-worker dask cluster;
                BASELINE.md / parcel_functions_demo.ipynb cells 23/30)
  vs_baseline — ours / 43.5
  extra       — the other arms' rates, the batch sizes and the card.

Runs fp32 on the first GPU and exits non-zero when JAX finds none; the
card's name and power limit go to stderr beside the timings.
"""

import json
import sys
import time

import numpy as np

REF_PIPELINE_COLS_PER_SEC = 225.0 / 5.17


def log(msg):
    print(f'[bench +{time.perf_counter() - _T0:7.1f}s] {msg}',
          file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def time_fn(fn, *args, iters=5):
    """Seconds per call of ``fn(*args)`` after a compiling first call:
    ``iters`` calls queued back to back (as a streaming producer would),
    then waited for."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    log(f'  compile+first run: {time.perf_counter() - t0:.1f}s')
    t0 = time.perf_counter()
    jax.block_until_ready([fn(*args) for _ in range(iters)])
    return (time.perf_counter() - t0) / iters


def main():
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from __graft_entry__ import _synthetic_columns, synthetic_inputs
    from xarray_parcel_tpu import adiabat, cape, deploy, fused, pipeline
    from xarray_parcel_tpu.parallel import make_mesh, replicate, shard_batch
    from xarray_parcel_tpu.utils.device import card_lines, require_gpu

    devices = require_gpu()
    card = card_lines()[0]
    log(f'{devices[0].device_kind} x {len(devices)}: {card}')
    deploy.enable_compilation_cache(min_compile_time_secs=2.0)

    tables = adiabat.load_moist_adiabat_lookups(dtype=jnp.float32)
    tables = jax.tree_util.tree_map(jax.device_put, tables)
    jax.block_until_ready(tables)
    log('tables loaded + device_put')

    # --- full pipeline (the reference's headline benchmark) ---
    B_pipe = 1 << 20
    dat = {k: jnp.asarray(v)
           for k, v in synthetic_inputs((B_pipe,)).items()}
    rates = {}
    for name, fn in (('fused', pipeline.conv_properties_fused),
                     ('modular', pipeline.conv_properties),
                     ('min_fused', pipeline.min_conv_properties_fused)):
        sec = time_fn(jax.jit(lambda d, fn=fn: fn(d, tables=tables)), dat)
        rates[name] = B_pipe / sec
        log(f'pipeline ({name}): {sec:.3f}s/iter at B={B_pipe} '
            f'({rates[name]:.4g} cols/sec) on {card}')
    del dat

    # --- surface-based CAPE/CIN only ---
    B_cape = 1 << 21
    p, t, td = (jnp.asarray(v) for v in _synthetic_columns((B_cape,)))

    def sb(solve):
        @jax.jit
        def run(p, t, td):
            res = solve(p, t, td, tables=tables)[0]
            return res['cape'], res['cin']
        return run

    mesh = make_mesh(devices[:1])
    tables_r = replicate(tables, mesh)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                       in_specs=(P('data'),) * 3, out_specs=(P('data'),) * 2)
    def sb_sharded(p, t, td):
        res, _ = fused.fused_surface_cape_cin(p, t, td, tables=tables_r)
        return res['cape'], res['cin']

    for name, fn, args in (
            ('cape_fused', sb(fused.fused_surface_cape_cin), (p, t, td)),
            ('cape_xla', sb(cape.surface_based_cape_cin), (p, t, td)),
            ('cape_sharded', sb_sharded, shard_batch((p, t, td), mesh))):
        sec = time_fn(fn, *args)
        rates[name] = B_cape / sec
        log(f'{name}: {sec:.3f}s/iter at B={B_cape} '
            f'({rates[name]:.4g} cols/sec) on {card}')

    print(json.dumps({
        'metric': 'conv_properties_pipeline_columns_per_sec',
        'value': round(rates['fused'], 1),
        'unit': 'columns/sec/card (90-level, ~20-var pipeline, fp32)',
        'vs_baseline': round(rates['fused'] / REF_PIPELINE_COLS_PER_SEC, 1),
        'extra': {
            'surface_cape_cin_columns_per_sec': round(rates['cape_fused'],
                                                      1),
            'surface_cape_cin_xla_columns_per_sec': round(
                rates['cape_xla'], 1),
            'surface_cape_cin_sharded_columns_per_sec': round(
                rates['cape_sharded'], 1),
            'pipeline_modular_xla_columns_per_sec': round(rates['modular'],
                                                          1),
            'pipeline_min_fused_columns_per_sec': round(rates['min_fused'],
                                                        1),
            'pipeline_batch': B_pipe,
            'cape_batch': B_cape,
            'backend': jax.default_backend(),
            'device': devices[0].device_kind,
            'card': card,
        },
    }))


if __name__ == '__main__':
    main()
