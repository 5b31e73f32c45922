"""Build examples/demo.ipynb (the executable walkthrough notebook).

The committed notebook is generated by this script and then executed with
``jupyter nbconvert --to notebook --execute --inplace examples/demo.ipynb``
so its outputs are real.  Regenerate after changing the cells below.
"""

import os

import nbformat as nbf

HERE = os.path.dirname(os.path.abspath(__file__))

nb = nbf.v4.new_notebook()
cells = []


def md(text):
    cells.append(nbf.v4.new_markdown_cell(text.strip()))


def code(text):
    cells.append(nbf.v4.new_code_cell(text.strip()))


md("""
# xarray_parcel on an accelerator — demo walkthrough

A tour of the JAX convection-diagnostics framework, mirroring the
reference's `parcel_functions_demo.ipynb` flow: per-function calls on a
single sounding, a plotted parcel ascent, the one-call gridded pipeline,
and (beyond the reference) exact gradients through the whole solve.

The compute path is pure JAX — everything here jit-compiles unchanged for
CPU or GPU, and the production path additionally fuses the CAPE/CIN
solve into a single column program (`xarray_parcel_tpu.fused`).  See
`docs/performance.md` for the performance model and `examples/multichip.py` for
the sharded multi-chip version of the pipeline.
""")

code("""
import os, sys
sys.path.insert(0, os.path.dirname(os.getcwd()) if os.path.basename(os.getcwd()) == 'examples' else os.getcwd())
sys.path.insert(0, os.path.join(sys.path[1], 'examples') if os.path.basename(sys.path[1]) != 'examples' else sys.path[1])

import jax
# The demo pins the CPU backend + fp64 so the printed values are exactly
# the documented (and MetPy-golden) numbers on any machine.  Delete these
# lines to run on an attached GPU (fp32 production envelope:
# docs/performance.md).  The 8 virtual CPU devices stand in for an
# multi-card host in the mesh-sharding section below.
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
jax.config.update('jax_num_cpu_devices', 8)

import jax.numpy as jnp
import numpy as np
from xarray_parcel_tpu import api

tables = api.load_moist_adiabat_lookups()
print('backend:', jax.default_backend(),
      '| adiabat curve table:', tables.curves.shape, tables.curves.dtype)
""")

md("""
## One sounding, three parcels

The golden sounding from the reference's unit tests.  `surface_based_`,
`most_unstable_` and `mixed_layer_cape_cin` correspond to
reference `modules/parcel_functions.py:1477`, `:1557` and `:1651`.
""")

code("""
pressure = jnp.array([959., 779.2, 751.3, 724.3, 700., 269.])        # hPa
temperature = jnp.array([22.2, 14.6, 12., 9.4, 7., -38.]) + 273.15   # K
dewpoint = jnp.array([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15

for name, fn in [('surface-based', api.surface_based_cape_cin),
                 ('most-unstable', api.most_unstable_cape_cin),
                 ('mixed-layer', api.mixed_layer_cape_cin)]:
    res = fn(pressure, temperature, dewpoint)[0]
    print(f"{name:>14}:  CAPE {float(res['cape']):8.2f} J/kg   "
          f"CIN {float(res['cin']):8.2f} J/kg")
""")

md("""
## The parcel ascent, plotted

`parcel_profile_with_lcl` (reference `:806`) lifts the surface parcel dry-
adiabatically to its condensation level and moist-adiabatically above it,
splicing the LCL into the column as an extra level.
""")

code("""
# A realistic 60-level sounding: ISA-shaped troposphere with a warm,
# moist boundary layer (dewpoint depression growing with height).
p_np = np.linspace(1008.0, 120.0, 60)
t_np = np.maximum(302.0 * (p_np / 1008.0) ** 0.1903, 205.0)
td_np = t_np - (2.0 + 28.0 * (1.0 - p_np / 1008.0) ** 1.5)
p_d, t_d, td_d = (jnp.asarray(v) for v in (p_np, t_np, td_np))

prof = api.parcel_profile_with_lcl(p_d, t_d, td_d,
                                   p_d[0], t_d[0], td_d[0])
print('LCL: %.1f hPa, %.1f K' % (float(prof['lcl_pressure']),
                                 float(prof['lcl_temperature'])))
""")

code("""
import matplotlib.pyplot as plt

SURFACE, TEXT, MUTED = '#fcfcfb', '#0b0b0b', '#52514e'
SERIES = {'environment': '#2a78d6', 'dewpoint': '#eb6834',
          'parcel': '#1baf7a'}

fig, ax = plt.subplots(figsize=(6.4, 6.0), facecolor=SURFACE)
ax.set_facecolor(SURFACE)
pp = np.asarray(prof['pressure'])
for name, track in [('environment', prof['environment_temperature']),
                    ('dewpoint', prof['environment_dewpoint']),
                    ('parcel', prof['temperature'])]:
    ax.plot(np.asarray(track) - 273.15, pp, color=SERIES[name],
            linewidth=2, label=name)
lclp = float(prof['lcl_pressure'])
ax.axhline(lclp, color=MUTED, linewidth=1, linestyle=':', zorder=1)
ax.annotate(f'LCL  {lclp:.0f} hPa', (ax.get_xlim()[0], lclp),
            xytext=(4, 4), textcoords='offset points', color=MUTED,
            fontsize=9)
ax.set_yscale('log')
ax.invert_yaxis()
ax.set_yticks([1000, 850, 700, 500, 400, 300, 200, 150])
ax.get_yaxis().set_major_formatter('{x:.0f}')
ax.set_xlabel('temperature [°C]', color=TEXT)
ax.set_ylabel('pressure [hPa]', color=TEXT)
ax.tick_params(colors=MUTED)
for s in ax.spines.values():
    s.set_color(MUTED); s.set_linewidth(0.5)
ax.grid(True, which='major', color=MUTED, alpha=0.15, linewidth=0.5)
ax.legend(frameon=False, labelcolor=TEXT)
ax.set_title('Parcel ascent vs environment', color=TEXT, loc='left')
plt.tight_layout(); plt.show()
""")

md("""
## The gridded pipeline on the Dataset surface

`conv_properties` (reference `:1951`) computes all 21 convection
diagnostics for every column of a Dataset in one jit-compiled program;
`storm_proxies` (reference `:2323`) derives the literature storm-proxy
flags.  With real `xarray` installed the same code runs on real Datasets;
here the vendored `xr_lite` stub provides the container.
""")

code("""
import xarray_parcel_tpu.xarray_api as parcel
try:
    import xarray as xr
except ImportError:
    from xarray_parcel_tpu import xr_lite as xr

from demo import synthetic_dataset

raw = synthetic_dataset(8)            # (8, 8) columns, 60 levels
ds = xr.Dataset({
    k: xr.DataArray(v, dims=('x', 'y', 'model_level_number')[:v.ndim])
    for k, v in raw.items()})
out = parcel.conv_properties(ds)
prox = parcel.storm_proxies(out)
for k in ('mu_cape', 'mu_cin', 'mixed_100_cape', 'mu_lifted_index',
          'temp_500', 'freezing_level'):
    v = np.asarray(out[k].values)
    print(f'{k:>22}: mean {np.nanmean(v):9.2f}  max {np.nanmax(v):9.2f}')
ship = np.asarray(prox['ship'].values)
n_valid = int(np.isfinite(ship).sum())
print(f'{"SHIP":>22}: {n_valid}/{ship.size} columns inside the SPC '
      'validity windows' + (f', mean {np.nanmean(ship):.3f}' if n_valid
                            else ' (NaN outside them, per SPC)'))
""")

md("""
## Accuracy: the vector pipeline vs an independent serial oracle

The reference demonstrates accuracy by diffing its vectorised results
against serial MetPy on a sample of grid points (its demo cells 23-30).
Same walkthrough here, with a stronger oracle: `tests/serial_oracle.py`
is an *independent* SciPy implementation (`solve_ivp` moist adiabats,
`fixed_point` LCL, `np.interp` splices — deliberately different
numerics), run column by column.  The table below is the reference's
`compare_results` diff table over every parcel variant.
""")

code("""
import sys
ROOT = (os.path.dirname(os.getcwd())
        if os.path.basename(os.getcwd()) == 'examples' else os.getcwd())
sys.path.insert(0, os.path.join(ROOT, 'tests'))
import serial_oracle as oracle
from xarray_parcel_tpu import diagnostics as diag, thermo, utils
from xarray_parcel_tpu.parcels import (mixed_layer_cape_cin,
                                       most_unstable_cape_cin)

# A 4x4 sample of convective columns (fixed seed, like the reference's
# 15x15 sample of its evaluation grid).
pts = synthetic_dataset(4)
P, T = jnp.asarray(pts['pressure']), jnp.asarray(pts['temperature'])
TD = thermo.dewpoint_from_specific_humidity(
    P, T, jnp.asarray(pts['specific_humidity']))

def vector(p, t, td):
    out = {}
    for name, (fn, kw) in {
            'mu': (most_unstable_cape_cin, dict(depth=250.0)),
            'm100': (mixed_layer_cape_cin, dict(depth=100.0)),
            'm50': (mixed_layer_cape_cin, dict(depth=50.0))}.items():
        res, prof, parcel = fn(p, t, td, **kw)
        li = diag.lifted_index(prof)['lifted_index']
        out[f'{name}_cape'] = res['cape']
        out[f'{name}_cin'] = res['cin']
        out[f'{name}_lifted_index'] = li
        out[f'{name}_dci'] = diag.deep_convective_index(p, t, td,
                                                        li)['dci']
    return out

vec = {k: np.asarray(v) for k, v in jax.jit(vector)(P, T, TD).items()}

ser = {k: np.full(P.shape[:2], np.nan) for k in vec}
for i in range(P.shape[0]):
    for j in range(P.shape[1]):
        col = (np.asarray(P[i, j]), np.asarray(T[i, j]),
               np.asarray(TD[i, j]))
        for name, res in (
                ('mu', oracle.most_unstable_cape_cin_column(*col,
                                                            depth=250.0)),
                ('m100', oracle.mixed_layer_cape_cin_column(*col,
                                                            depth=100.0)),
                ('m50', oracle.mixed_layer_cape_cin_column(*col,
                                                           depth=50.0))):
            li = oracle.lifted_index_column(res)
            ser[f'{name}_cape'][i, j] = res['cape']
            ser[f'{name}_cin'][i, j] = res['cin']
            ser[f'{name}_lifted_index'][i, j] = li
            ser[f'{name}_dci'][i, j] = oracle.dci_column(*col, li)

reports = utils.compare_results(vec, ser, tolerance=1.0)
assert all(r['within_tolerance'] for r in reports)
""")

md("""
Differences sit at the fp/interpolation-noise floor (the oracle solves
the *exact* moist-adiabat ODE per column; the vector path evaluates the
spectral fit of the same curves — the table-envelope bound is
≤ 1.2×10⁻⁴ K, `docs/performance.md`).  CAPE/CIN agree to well under
1 J/kg everywhere on this sample — the reference accepts O(1 J/kg)
differences against serial MetPy at this point (its demo cell 28).

### Swapping the moist-lapse backend (the reference's oracle trick)

The reference validates its lookup-table `moist_lapse` by monkeypatching
MetPy's analytic version into the same pipeline (demo cells 25, 33).
The equivalent here is an argument, not a monkeypatch: every parcel
function takes `moist_lapse=`, and `adiabat.moist_lapse_integrate` is
the exact-RK4 oracle backend the golden tests run against.
""")

code("""
from xarray_parcel_tpu import adiabat

res_tab, prof_tab, _ = most_unstable_cape_cin(P, T, TD, depth=250.0)
res_ode, prof_ode, _ = most_unstable_cape_cin(
    P, T, TD, depth=250.0, moist_lapse=adiabat.moist_lapse_integrate)
dt = np.abs(np.asarray(prof_tab['temperature']) -
            np.asarray(prof_ode['temperature']))
dc = np.abs(np.asarray(res_tab['cape']) - np.asarray(res_ode['cape']))
print('spectral-table vs exact-ODE moist-lapse backend, over the sample:')
print(f'  parcel profile temperature: max |diff| {np.nanmax(dt):.2e} K '
      f'(table envelope bound: 1.2e-4 K)')
print(f'  MU CAPE: max |diff| {np.nanmax(dc):.2e} J/kg '
      f'(errors oscillate along the curve and largely cancel in the '
      f'area integral)')
""")

md("""
### The ported unit tests

The reference's demo runs its MetPy-derived unit-test suite in-line
(cells 31-35).  All 59 of those tests exist here under their reference
names; the golden subset runs below against the exact-ODE oracle
backend, exactly as the reference does it.
""")

code("""
import subprocess
r = subprocess.run(
    [sys.executable, '-m', 'pytest', 'tests/test_golden_metpy.py',
     'tests/test_reference_names.py', '-q', '--no-header'],
    cwd=ROOT, capture_output=True, text=True)
print(r.stdout.strip().splitlines()[-1])
assert r.returncode == 0
""")

md("""
## Scaling: vector pipeline vs the serial oracle

The reference's closing benchmark (demo cells 48-52) times its
vectorised CAPE/CIN against serial MetPy over growing grids.  Same
shape here: the serial SciPy oracle is timed on a handful of columns
(then extended at its measured per-column rate — it is exactly linear),
the jit-compiled vector solve is timed end to end at each size.  This
cell runs on the demo's pinned CPU backend, so the vector numbers are a
*floor* — device rates, measured on the H100, are in `PERF.md`
(cost model: `docs/performance.md`).
""")

code("""
import time

def time_of(fn, *args, iters=3):
    fn(*args)                                  # warm/compile
    t0 = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters

# Serial oracle: measured on 8 columns, linear in points.
cols = [(np.asarray(P[i, j]), np.asarray(T[i, j]), np.asarray(TD[i, j]))
        for i in range(2) for j in range(4)]
t0 = time.perf_counter()
for col in cols:
    oracle.surface_cape_cin_column(*col)
serial_per_col = (time.perf_counter() - t0) / len(cols)

from xarray_parcel_tpu import cape
solve = jax.jit(lambda p, t, td: cape.surface_based_cape_cin(
    p, t, td)[0]['cape'])
sizes = [64, 256, 1024, 4096]
vec_times = []
for n in sizes:
    big = synthetic_dataset(int(np.ceil(np.sqrt(n))))
    pb = jnp.asarray(big['pressure']).reshape(-1, P.shape[-1])[:n]
    tb = jnp.asarray(big['temperature']).reshape(-1, P.shape[-1])[:n]
    db = thermo.dewpoint_from_specific_humidity(
        pb, tb, jnp.asarray(big['specific_humidity']
                            ).reshape(-1, P.shape[-1])[:n])
    vec_times.append(time_of(solve, pb, tb, db))
serial_times = [serial_per_col * n for n in sizes]
for n, sv, vv in zip(sizes, serial_times, vec_times):
    print(f'{n:6d} columns: serial {sv:8.2f} s   vector {vv:8.4f} s   '
          f'speedup {sv / vv:8.0f}x')
""")

code("""
fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10.4, 4.2),
                               facecolor=SURFACE)
marks = {'serial oracle (SciPy)': (serial_times, SERIES['environment'],
                                   'o'),
         'vector (jit, CPU)': (vec_times, SERIES['dewpoint'], 's')}
for ax in (ax1, ax2):
    ax.set_facecolor(SURFACE)
    ax.tick_params(colors=MUTED)
    for s in ax.spines.values():
        s.set_color(MUTED); s.set_linewidth(0.5)
    ax.grid(True, which='major', color=MUTED, alpha=0.15, linewidth=0.5)
    ax.set_xlabel('columns', color=TEXT)
for name, (ts, color, m) in marks.items():
    ax1.plot(sizes, ts, color=color, linewidth=2, marker=m, markersize=6,
             label=name)
ax1.set_xscale('log'); ax1.set_yscale('log')
ax1.set_ylabel('processing time [s]', color=TEXT)
ax1.legend(frameon=False, labelcolor=TEXT)
ax1.set_title('Processing time', color=TEXT, loc='left')

sp = [s / v for s, v in zip(serial_times, vec_times)]
ax2.plot(sizes, sp, color=SERIES['parcel'], linewidth=2, marker='o',
         markersize=6)
ax2.set_xscale('log')
ax2.set_ylabel('speedup over serial [x]', color=TEXT)
ax2.annotate(f'{sp[-1]:,.0f}x at {sizes[-1]:,} columns',
             (sizes[-1], sp[-1]), xytext=(-8, -14),
             textcoords='offset points', ha='right', color=TEXT,
             fontsize=9)
ax2.set_title('Speedup (single CPU core)',
              color=TEXT, loc='left')
plt.tight_layout(); plt.show()
""")

md("""
## Scaling out: the pipeline on a device mesh

The reference opens its demo by starting a two-worker dask
`LocalCluster` (its cell 3); the JAX equivalent is a
`jax.sharding.Mesh` — columns are independent, so the only parallel
decision is sharding the batch axis, and XLA inserts no collectives.
This notebook's pinned CPU backend exposes 8 virtual devices (first
cell), standing in for a multi-card host; on real hardware the same two
lines shard over the cards.  Any grid shape works — a mesh that does not
divide the batch pads, computes sharded, and slices the padding off.
""")

code("""
from xarray_parcel_tpu import parallel

print(f'{len(jax.devices())} devices:', jax.devices()[:3], '...')
mesh = parallel.make_mesh(jax.devices())
out_sharded = parcel.conv_properties(ds, mesh=mesh)

def f64(x):
    return np.asarray(x.values if hasattr(x, 'values') else x, np.float64)

def worst_diff(got, ref):
    \"\"\"(max |diff| over non-NaN points, NaN patterns identical) per var.\"\"\"
    worst, nan_same = 0.0, True
    for k in getattr(ref, 'data_vars', ref):
        a, b = f64(got[k]).reshape(-1), f64(ref[k]).reshape(-1)
        d = np.abs(a - b)
        worst = max(worst, float(np.max(np.where(np.isnan(d), 0.0, d))))
        nan_same &= np.array_equal(np.isnan(a), np.isnan(b))
    return worst, nan_same

worst, nan_same = worst_diff(out_sharded, out)
print(f'sharded vs single-device: worst |diff| {worst:.1e}, '
      f'NaN patterns identical: {nan_same}')
""")

md("""
## Out-of-core grids: streaming and chunked execution

Where the reference leans on dask's lazy chunked graphs for grids that
don't fit in memory, two composable tools cover the same ground
(`docs/performance.md` has the measured trade-offs):

- `stream_map` / `stream_columns=` — host-side chunk streaming with
  double-buffered transfers (optionally sharding each chunk over the
  mesh, for grids bigger than one device's HBM);
- `parallel.chunked` — the whole batch stays on device but executes
  chunk-by-chunk under `lax.map` inside ONE compiled program, for
  batches whose whole-batch XLA schedule will not compile.
""")

code("""
from xarray_parcel_tpu import pipeline

# Streaming, on the Dataset surface (vs the whole-grid Dataset run):
out_streamed = parcel.conv_properties(ds, stream_columns=16, mesh=mesh)
worst, nan_same = worst_diff(out_streamed, out)
print(f'streamed (16-col chunks) vs whole-grid: worst |diff| {worst:.1e}, '
      f'NaN patterns identical: {nan_same}')

# lax.map chunking, on the dict surface (vs the same dict program whole —
# the Dataset surface quantises its egress to the input dtype, so the
# apples-to-apples comparison stays on one surface):
flat = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])
        for k, v in raw.items()}
whole_flat = pipeline.conv_properties(
    {k: jnp.asarray(v) for k, v in flat.items()})
out_chunked = parallel.scan_map(
    lambda d: pipeline.conv_properties(d), flat, chunk_columns=16)
worst, nan_same = worst_diff(out_chunked, whole_flat)
print(f'lax.map-chunked vs whole-batch: worst |diff| {worst:.1e}, '
      f'NaN patterns identical: {nan_same}')
""")

md("""
## Regression drift vs the committed archive

The reference's `environment_changes_eval.ipynb` diffs a fresh run
against an archived NetCDF of historic results, variable by variable.
Same workflow here: recompute the full pipeline from the committed
regression archive's inputs and print the drift table
(`utils.compare_archives`) — all ~50 variables, including the storm
proxies and the reduced pipeline, at zero drift unless semantics
intentionally changed (in which case
`tests/make_regression_archive.py` regenerates the archive *and*
commits the quantified drift record).
""")

code("""
arch_path = os.path.join(ROOT, 'tests', 'data',
                         'regression_conv_properties.npz')
arch = np.load(arch_path)
inputs = {k[3:]: jnp.asarray(v) for k, v in arch.items()
          if k.startswith('in_')}
cur = pipeline.conv_properties(inputs)
cur.update(pipeline.storm_proxies(cur))
cur.update({f'min.{k}': v
            for k, v in pipeline.min_conv_properties(inputs).items()})
report = utils.compare_archives(
    {k: np.asarray(v) for k, v in cur.items()}, arch_path,
    print_report=False)
print(f"{len(report['variables'])} shared variables, "
      f"{report['n_differs']} exceed tolerance, "
      f"equal: {report['equal']}")
assert report['equal']
""")

md("""
## Exact gradients through the solve (beyond the reference)

Every diagnostic is differentiable end to end — `jax.grad` gives the
exact sensitivity of CAPE to each observed level, something the
reference's dask/numba stack cannot express.  (The NaN-aware ops are
built so masked levels contribute finite zero gradients.)
""")

code("""
def cape_of(t):
    return api.surface_based_cape_cin(pressure, t, dewpoint)[0]['cape']

g = jax.grad(cape_of)(temperature)
order = np.argsort(-np.abs(np.asarray(g)))[:5]
print('CAPE = %.1f J/kg' % float(cape_of(temperature)))
print('most sensitive levels (dCAPE/dT, J/kg per K):')
for i in order:
    print(f'  {float(pressure[i]):7.1f} hPa: {float(g[i]):+8.2f}')
""")

md("""
## Serving: export once, run anywhere (beyond the reference)

For production the pipeline AOT-exports to a serialized StableHLO
artifact.  The pipelines read only the ~2–5 MB spectral coefficients at
runtime (the 300 MB curve/lookup tables are build-time inputs), so the
artifact **embeds them and is fully standalone**: a serving process
`deploy.load`s the zip and runs with **zero retracing, no table cache
and no table build** — note the serve below passes no `tables` at all —
and `deploy.enable_compilation_cache` makes the backend compile a
once-per-machine cost.  A fixed-batch artifact serves *any* grid size —
inputs NaN-pad up to the exported batch and run chunk-by-chunk.  The
reference re-builds its dask graph every session; here the compiled
program ships as one file.
""")

code("""
import tempfile
from xarray_parcel_tpu import deploy, pipeline

grid = {k: jnp.asarray(v.reshape(-1, v.shape[-1]) if v.ndim == 3
                       else v.reshape(-1)) for k, v in raw.items()}

with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, 'conv_properties.xpz')
    dep = deploy.export_pipeline('conv_properties', batch=48, levels=60,
                                 dtype=jnp.float64, path=path)
    print(f'artifact: {os.path.getsize(path):,} bytes '
          f'(standalone: slim={dep.meta["slim"]})')
    served = deploy.load(path)(grid)          # 64 columns via a 48-batch
                                              # artifact: pad + 2 chunks;
                                              # NO tables argument
direct = pipeline.conv_properties(grid)
worst = max(float(np.nanmax(np.abs(np.asarray(served[k]) -
                                   np.asarray(direct[k]))))
            for k in direct if np.asarray(direct[k]).dtype != bool)
print(f'served (pad+chunked) vs direct, worst |diff|: {worst:.1e}')
""")

md("""
## Where to go next

- `examples/multichip.py` — the same pipeline sharded over a
  `jax.sharding.Mesh` (data-parallel columns, replicated tables).
- `examples/environment_eval.ipynb` — the regression-drift evaluation
  walkthrough (archive vs archive, root-caused).
- `examples/xarray_demo.py` — the full per-function Dataset surface.
- `chip_smoke.py`, `bench.py`, `PERF.md` — the card's measured
  rates (every number beside the card's name and power limit;
  `docs/performance.md` has the cost model).
- `docs/migration.md` — function-by-function mapping from the reference.
""")

nb['cells'] = cells
nb['metadata']['kernelspec'] = {
    'display_name': 'Python 3', 'language': 'python', 'name': 'python3'}
path = os.path.join(HERE, 'demo.ipynb')
with open(path, 'w') as f:
    nbf.write(nb, f)
print('wrote', path)
