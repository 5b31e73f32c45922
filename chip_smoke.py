"""Smoke run of the convection pipelines on an NVIDIA GPU.

Drives the main user paths once at production width, through the entry
points a user calls, on the card as compiled for it, and checks what comes
out against the repository's own references.  Phases, one card:

1. device: JAX's first device must be a GPU; prints the card and its power
   limit as nvidia-smi reports them.
2. tables: load or build the moist-adiabat tables the way a first user run
   does (it builds them when ``adiabat_lookups/`` is absent).
3. pipelines: ``conv_properties`` + ``storm_proxies``,
   ``conv_properties_fused`` and ``min_conv_properties_fused`` under jit
   at 2^20 columns x 90 levels, fp32, host arrays in and out: compile and
   steady seconds, columns per second and peak device memory.
4. dataset: ``xarray_api.conv_properties`` on a 1024 x 1024 x 90 Dataset.
5. deploy: export ``conv_properties_fused_with_proxies`` at batch 2^18,
   save and load it (where JAX can serialize) and serve three grids; each
   equals the direct call.
6. accuracy: the fp32 pipelines against the fp64 modular pipeline, within
   the bounds of tests/test_fp32_budget.py; fp64 against the committed
   regression archive at its test's tolerance.
7. on-card tests: the ``gpu``-marked tests, in this process.

With ``--four-cards`` it runs only the mesh path on four cards and what it
is compared with: pad -> shard -> ``conv_properties`` on an uneven batch
against the one-card result, ``stream_map(mesh=)``, ``global_stats`` and a
mesh-exported (``deploy`` ``mesh=``) artifact served.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
a failed phase exits non-zero before it.  Run from the root of a checkout:

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the mesh path on four cards
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, 'tests')]

import jax
import jax.numpy as jnp

import xarray_parcel_tpu
from __graft_entry__ import synthetic_inputs
from xarray_parcel_tpu import (adiabat, deploy, parallel, pipeline,
                               xarray_api, xr_lite)
from xarray_parcel_tpu.utils import device as _device

if os.path.dirname(os.path.dirname(
        os.path.abspath(xarray_parcel_tpu.__file__))) != HERE:
    raise SystemExit('chip_smoke.py must run from the root of a checkout '
                     'of this repository')

#: fp32 accuracy budget of tests/test_fp32_budget.py: per variable, the
#: p95 and max relative error at the variable's own scale, and the share
#: of NaN-pattern (float) or value (bool) flips.
FP32_BUDGET = {'p95': 1e-4, 'max': 5e-4, 'nan_flips': 0.01,
               'bool_flips': 0.05}
WORK_DIR = os.path.join(HERE, 'build', 'chip_smoke')
WITH_PROXIES = 'conv_properties_with_proxies'
FUSED_WITH_PROXIES = 'conv_properties_fused_with_proxies'


def log(msg):
    print(msg, flush=True)


def check_device(count=1):
    """JAX's devices and the cards' nvidia-smi lines; RuntimeError unless
    JAX's first device is a GPU and at least ``count`` are visible."""
    devices = _device.require_gpu()
    if len(devices) < count:
        raise RuntimeError(f'needs {count} GPUs; JAX sees {len(devices)}')
    return devices, _device.card_lines()


def fp32_envelope(ref, got):
    """Per-variable error of ``got`` (fp32 run) against ``ref`` (fp64 run):
    ``{name: {'p95', 'max', 'nan_flips'}}`` for floats (relative to the
    variable's own scale, as in tests/test_fp32_budget.py) and
    ``{name: {'bool_flips'}}`` for booleans."""
    env = {}
    for k in sorted(set(ref) & set(got)):
        a = np.asarray(ref[k])
        b = np.asarray(got[k])
        if a.dtype == bool:
            env[k] = {'bool_flips': float(np.mean(a != b.astype(bool)))}
            continue
        b = b.astype(np.float64)
        row = {'nan_flips': float(np.mean(np.isnan(a) != np.isnan(b))),
               'p95': 0.0, 'max': 0.0}
        both = ~np.isnan(a) & ~np.isnan(b)
        if both.any():
            scale = max(1.0, float(np.nanmax(np.abs(a))))
            d = np.abs(a[both] - b[both]) / scale
            row.update(p95=float(np.quantile(d, 0.95)), max=float(d.max()))
        env[k] = row
    return env


def budget_violations(env, budget=FP32_BUDGET):
    """``['name: stat value > bound', ...]`` for every envelope entry over
    its bound (empty when the run is within budget)."""
    return [f'{k}: {s} {v:.3g} > {budget[s]:.3g}'
            for k, row in sorted(env.items()) for s, v in row.items()
            if v > budget[s]]


def worst(env):
    """``{stat: (largest value, variable)}`` over all variables."""
    out = {}
    for k, row in sorted(env.items()):
        for s, v in row.items():
            if s not in out or v > out[s][0]:
                out[s] = (v, k)
    return out


def mismatch(ref, got, rtol=2e-5, atol=2e-4):
    """Share of elements of each variable where two fp32 runs of the same
    pipeline disagree (NaN pattern, boolean value, or value beyond
    ``rtol``/``atol``), and the largest absolute difference."""
    out = {}
    for k in sorted(ref):
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype == bool:
            bad = a != b
            diff = 0.0
        else:
            bad = ~np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)
            both = ~np.isnan(a) & ~np.isnan(b)
            diff = float(np.max(np.abs(a[both] - b[both]), initial=0.0))
        out[k] = (float(np.mean(bad)), diff)
    return out


def assert_agree(name, ref, got, limit=1e-5):
    """Two runs of one pipeline agree on all but ``limit`` of elements."""
    mm = mismatch(ref, got)
    frac = max(f for f, _ in mm.values())
    diff = max(d for _, d in mm.values())
    log(f'  {name}: {len(mm)} variables; worst mismatch share {frac:.3g}, '
        f'largest abs difference {diff:.3g}')
    bad = {k: v for k, v in mm.items() if v[0] > limit}
    assert not bad, f'{name}: mismatch share over {limit}: {bad}'


def check_outputs(name, out, batch):
    """Every output has the batch shape; the CAPE fields are finite and
    non-negative on the NaN-free synthetic columns."""
    for k, v in out.items():
        assert np.shape(v) == batch, (name, k, np.shape(v))
    for k in ('mu_cape', 'mixed_100_cape'):
        if k in out:
            v = np.asarray(out[k])
            assert np.isfinite(v).all() and (v >= 0).all(), (name, k)


def phase_tables():
    t0 = time.perf_counter()
    had_cache = os.path.isdir(adiabat._CACHE_DIR)
    tables = adiabat.load_moist_adiabat_lookups()
    tables = jax.tree_util.tree_map(jax.device_put, tables)
    jax.block_until_ready(tables)
    log(f'[tables] {"loaded" if had_cache else "built"} '
        f'{np.dtype(tables.curves.dtype).name} tables in '
        f'{time.perf_counter() - t0:.2f} s (set-up); the table build\'s '
        'matrix product asks precision=highest, so TF32 never applies')
    return tables


def phase_pipelines(dat, tables, card, dev, reps=3):
    batch = dat['pressure'].shape[:-1]
    cols = int(np.prod(batch))
    runs = {WITH_PROXIES: deploy.PIPELINES[WITH_PROXIES],
            'conv_properties_fused': pipeline.conv_properties_fused,
            'min_conv_properties_fused': pipeline.min_conv_properties_fused}
    outs = {}
    for name, fn in runs.items():
        jitted = jax.jit(lambda d, tab, fn=fn: fn(d, tables=tab))
        t0 = time.perf_counter()
        compiled = jitted.lower(dat, tables).compile()
        compile_s = time.perf_counter() - t0
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.device_get(compiled(dat, tables))
            secs.append(time.perf_counter() - t0)
        steady = float(np.median(secs))
        peak = (dev.memory_stats() or {}).get('peak_bytes_in_use',
                                              'not measured')
        check_outputs(name, out, batch)
        outs[name] = out
        log(f'[pipelines] {name}: {cols} columns x '
            f'{dat["pressure"].shape[-1]} levels fp32 on {card}: compile '
            f'{compile_s:.2f} s, steady {steady:.4f} s (median of {reps}, '
            f'host to host), {cols / steady:.4g} columns/s, '
            f'peak_bytes_in_use {peak} (process so far)')
    shared = set(outs[WITH_PROXIES]) & set(outs['conv_properties_fused'])
    mm = mismatch({k: outs[WITH_PROXIES][k] for k in shared},
                  {k: outs['conv_properties_fused'][k] for k in shared})
    log(f'[pipelines] fused vs modular at full size: worst mismatch share '
        f'{max(f for f, _ in mm.values()):.3g} over {len(mm)} variables')
    return outs


def phase_dataset(dat, tables, card, ref):
    shape = dat['pressure'].shape
    ny = int(np.sqrt(shape[0]))
    assert ny * ny == shape[0], shape
    dims = ('latitude', 'longitude', 'level')
    grid = {k: v.reshape((ny, ny) + v.shape[1:]) for k, v in dat.items()}
    ds = xr_lite.Dataset(
        {k: (dims[:v.ndim], v) for k, v in grid.items()},
        coords={'latitude': np.arange(ny, dtype=np.float64),
                'longitude': np.arange(ny, dtype=np.float64)})
    t0 = time.perf_counter()
    out = xarray_api.conv_properties(ds, vert_dim='level', tables=tables)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = xarray_api.conv_properties(ds, vert_dim='level', tables=tables)
    again = time.perf_counter() - t0
    assert out['mu_cape'].dims == ('latitude', 'longitude')
    got = {k: np.asarray(out[k].values).reshape(-1) for k in out}
    assert_agree('dataset vs array pipeline', {k: ref[k] for k in got}, got)
    log(f'[dataset] xarray_api.conv_properties on a {ny}x{ny}x{shape[1]} '
        f'Dataset on {card}: {len(got)} variables, first call '
        f'{first:.2f} s (compile included), second {again:.4f} s')


def saved_and_loaded(dep, name):
    """``dep`` written to an artifact file and loaded back — or ``dep``
    itself where this JAX cannot serialize (``jax.export`` needs the
    ``flatbuffers`` package to write and read artifacts; exporting and
    serving in memory do not, and tests/test_deploy.py covers the file
    round trip)."""
    if importlib.util.find_spec('flatbuffers') is None:
        log(f'[deploy] {name}: no flatbuffers package here, so no artifact '
            'file: serving the exported program in memory')
        return dep
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, f'{name}.xpz')
    dep.save(path)
    log(f'[deploy] {name}: saved ({os.path.getsize(path)} bytes) and '
        'loaded back')
    return deploy.load(path)


def phase_deploy(tables, card, levels, batch, grids):
    t0 = time.perf_counter()
    dep = deploy.export_pipeline(FUSED_WITH_PROXIES, batch=batch,
                                 levels=levels, tables=tables)
    log(f'[deploy] exported {FUSED_WITH_PROXIES} at batch {batch} in '
        f'{time.perf_counter() - t0:.2f} s (slim={dep.meta["slim"]}, '
        f'platforms={dep.meta["platforms"]})')
    served = saved_and_loaded(dep, FUSED_WITH_PROXIES)
    direct = jax.jit(lambda d, tab: deploy.PIPELINES[FUSED_WITH_PROXIES](
        d, tables=tab))
    for i, (ny, nx) in enumerate(grids):
        dat = synthetic_inputs((ny * nx,), L=levels, seed=100 + i)
        t0 = time.perf_counter()
        got = served(dat)
        serve_s = time.perf_counter() - t0
        ref = jax.device_get(direct(dat, tables))
        check_outputs('served', got, (ny * nx,))
        assert_agree(f'served {ny}x{nx} vs direct call', ref, got)
        log(f'[deploy] served {ny}x{nx} ({ny * nx} columns) on {card} in '
            f'{serve_s:.2f} s (first call per size includes compile)')


def phase_accuracy(card, envelope_grid=(64, 64, 90)):
    from make_regression_archive import (ARCHIVE, assert_matches_archive,
                                         compute, load_archive, make_inputs)

    jax.config.update('jax_enable_x64', True)
    t0 = time.perf_counter()
    tables64 = adiabat.load_moist_adiabat_lookups()
    assert np.dtype(tables64.curves.dtype) == np.float64
    tables32 = tables64.astype(jnp.float32)
    log(f'[accuracy] fp64 tables in {time.perf_counter() - t0:.2f} s; '
        'fp32 tables by astype, as in tests/test_fp32_budget.py')

    def run(fn, inputs, tab, dtype):
        dat = {k: jnp.asarray(v, dtype) for k, v in inputs.items()}
        return jax.device_get(jax.jit(lambda d, t: fn(d, tables=t))(dat,
                                                                   tab))

    def envelopes(inputs):
        ref = run(deploy.PIPELINES[WITH_PROXIES], inputs, tables64,
                  jnp.float64)
        ref_min = run(pipeline.min_conv_properties, inputs, tables64,
                      jnp.float64)
        out = {}
        for name, fn, r in (
                (WITH_PROXIES, deploy.PIPELINES[WITH_PROXIES], ref),
                (FUSED_WITH_PROXIES, deploy.PIPELINES[FUSED_WITH_PROXIES],
                 ref),
                ('min_conv_properties_fused',
                 pipeline.min_conv_properties_fused, ref_min)):
            got = run(fn, inputs, tables32, jnp.float32)
            assert all(np.asarray(v).dtype != np.float64
                       for v in got.values()), name
            out[name] = fp32_envelope(r, got)
        return out

    inputs = make_inputs()
    shape = inputs['pressure'].shape
    bad = []
    for name, env in envelopes(inputs).items():
        log(f'[accuracy] fp32 {name} vs fp64 conv_properties on the '
            f'{shape} budget grid on {card}: worst {worst(env)}')
        bad += [f'{name}/{v}' for v in budget_violations(env)]
    ny, nx, L = envelope_grid
    for name, env in envelopes(make_inputs(ny=ny, nx=nx, L=L)).items():
        log(f'[accuracy] envelope (reported, not bounded) of fp32 {name} '
            f'on a {ny}x{nx}x{L} grid: worst {worst(env)}')
    assert not bad, f'fp32 outside the budget of test_fp32_budget: {bad}'

    arch_in, expect = load_archive()
    assert_matches_archive(compute(arch_in), expect)
    log(f'[accuracy] fp64 on {card} matches {os.path.basename(ARCHIVE)}: '
        f'{len(expect)} variables at atol=1e-4*scale, rtol=1e-6')


def phase_card_tests():
    import pytest
    rc = pytest.main(['-q', '-m', 'gpu', '-p', 'no:cacheprovider',
                      os.path.join(HERE, 'tests', 'test_on_card.py')])
    assert rc == 0, f'gpu-marked tests failed (pytest exit code {rc})'
    log('[card tests] gpu-marked tests passed')


def four_cards(devices, tables, card, columns, levels, export_batch):
    """The mesh path on four devices against one device; returns nothing,
    raises on any disagreement."""
    mesh = parallel.make_mesh(devices[:4])
    dat = synthetic_inputs((columns,), L=levels, seed=7)
    step = jax.jit(lambda d, tab: deploy.PIPELINES[WITH_PROXIES](
        d, tables=tab))

    t0 = time.perf_counter()
    padded, b = parallel.pad_batch(dat, mesh)
    assert b == columns
    sharded = parallel.shard_batch(padded, mesh, batch_dims=1)
    tab4 = parallel.replicate(tables, mesh)
    sharded_out = step(sharded, tab4)
    assert len(sharded_out['mu_cape'].sharding.device_set) == 4
    out4 = {k: np.asarray(v)[:columns] for k, v in
            jax.device_get(sharded_out).items()}
    log(f'[four cards] pad -> shard -> conv_properties on {columns} '
        f'columns over {mesh.devices.size} x {card}: '
        f'{time.perf_counter() - t0:.2f} s (compile included)')
    one = jax.device_get(step(jax.device_put(dat, devices[0]),
                              jax.device_put(tables, devices[0])))
    assert_agree('four cards vs one card', one, out4)

    t0 = time.perf_counter()
    streamed = parallel.stream_map(
        lambda d: pipeline.conv_properties(d, tables=tab4), dat,
        batch_columns=columns // 3 + 1, mesh=mesh)
    log(f'[four cards] stream_map(mesh=) in 3 chunks: '
        f'{time.perf_counter() - t0:.2f} s (compile included)')
    assert_agree('stream_map(mesh=) vs sharded',
                 {k: out4[k] for k in streamed}, streamed)

    # The padded rows are NaN, which the finite-masked statistics skip.
    cnt, mean, mx = parallel.global_stats(sharded_out['mu_cape'], mesh)
    v = one['mu_cape'][np.isfinite(one['mu_cape'])]
    assert int(cnt) == v.size, (int(cnt), v.size)
    np.testing.assert_allclose([float(mean), float(mx)],
                               [v.mean(dtype=np.float64), v.max()],
                               rtol=1e-4)
    log(f'[four cards] global_stats (psum/pmax over {mesh.devices.size} '
        f'cards): {int(cnt)} finite mu_cape, mean {float(mean):.3f}, max '
        f'{float(mx):.3f} J/kg, equal to the one-card statistics')

    t0 = time.perf_counter()
    dep = deploy.export_pipeline('min_conv_properties', batch=export_batch,
                                 levels=levels, tables=tables, mesh=mesh)
    assert dep.meta['mesh'] == {'axis_names': ['data'], 'shape': [4]}
    got = saved_and_loaded(dep, 'min_conv_properties_mesh4')(dat)
    log(f'[four cards] export_pipeline(mesh=4 cards, batch {export_batch}) '
        f'and serve of {columns} columns: {time.perf_counter() - t0:.2f} s '
        '(compile included)')
    assert_agree('mesh-4 min_conv_properties artifact vs sharded run',
                 {k: out4[k] for k in got}, got)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the mesh path, on four cards')
    args = ap.parse_args(argv)
    count = 4 if args.four_cards else 1

    devices, cards = check_device(count)
    dev = devices[0]
    card = cards[0]
    log(f'[device] {dev.platform} {dev.device_kind} x {len(devices)}; '
        f'JAX {jax.__version__}')
    for line in cards[:count]:
        log(line)
    deploy.enable_compilation_cache(min_compile_time_secs=2.0)
    log(f'[device] compile cache: {jax.config.jax_compilation_cache_dir}')
    shutil.rmtree(WORK_DIR, ignore_errors=True)

    tables = phase_tables()
    if args.four_cards:
        four_cards(devices, tables, card, columns=(1 << 20) + 3, levels=90,
                   export_batch=1 << 19)
    else:
        t0 = time.perf_counter()
        dat = synthetic_inputs((1 << 20,), L=90, seed=0)
        log(f'[pipelines] synthetic inputs built on the host in '
            f'{time.perf_counter() - t0:.2f} s (set-up)')
        outs = phase_pipelines(dat, tables, card, dev)
        phase_dataset(dat, tables, card, outs[WITH_PROXIES])
        del dat, outs
        phase_deploy(tables, card, levels=90, batch=1 << 18,
                     grids=((1000, 1000), (721, 1440), (101, 101)))
        phase_accuracy(card)
        phase_card_tests()
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(devices)}}), flush=True)


if __name__ == '__main__':
    main()
