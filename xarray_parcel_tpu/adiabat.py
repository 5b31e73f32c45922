"""Moist (pseudo)adiabat engine: on-device RK4 integrator + lookup tables.

This replaces three reference components at once:

* MetPy's scipy-ODE ``moist_lapse`` (the reference's per-curve oracle);
* the reference's offline table builder ``moist_adiabat_lookup``
  (reference: modules/parcel_functions.py:447-523) — 14,300 pseudoadiabat
  curves at 0.01 K start-temperature spacing over 2,196 pressure levels
  (1100 → 2.5 hPa, 0.5 hPa step), plus a (pressure, temperature) → curve
  index lookup;
* the table consumer ``moist_lapse`` (reference: :525-607), whose hot inner
  loop was a numba gufunc ``np.interp`` over the gathered curve.

Accelerator-first redesign:
  * the curves are generated on device by a ``lax.scan`` RK4 integrator in
    log-pressure (replacing the failed Euler path in
    reference: modules/moist_lapse_analytic.py), on a statically refined grid
    so every interval's local error is negligible;
  * both table axes are uniform, so the (p, T) → curve "nearest" lookup and
    the curve interpolation collapse to pure index arithmetic + gathers — no
    searchsorted, no data-dependent shapes, everything fuses under XLA;
  * the curve-index table is built by inverse interpolation over the (strictly
    monotone in curve index) curve temperatures at each pressure, which is the
    exact form of the reference's two-pass rounding fill;
  * ``moist_lapse_integrate`` integrates the ODE directly per query — the
    test oracle, playing the role of the reference's
    ``metpy_moist_lapse`` monkeypatch (reference: modules/unit_tests.py:114).

Tables are plain pytrees (device-resident, donated once), not module
globals — though a module-level default is kept for API parity with the
reference's ``load_moist_adiabat_lookups`` (reference:
modules/parcel_functions.py:39-61).
"""

import functools
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from .ops.safe import notnan
from .thermo import moist_lapse_rate

# Reference table grid (reference: modules/parcel_functions.py:447-451).
P_TOP = 1100.0          # hPa, start of every curve (highest pressure)
P_BOT = 2.5             # hPa, lowest pressure
P_STEP = 0.5            # hPa
N_PRES = int(round((P_TOP - P_BOT) / P_STEP)) + 1     # 2196
T_MIN = 173.0           # K
T_MAX_EXCL = 316.0      # K (exclusive, arange semantics)
T_STEP = 0.02           # K
N_TEMP = int(round((T_MAX_EXCL - T_MIN) / T_STEP))    # 7150
N_CURVES = 2 * N_TEMP                                  # 14300 (offsets 0, 0.01)
CURVE_OFFSET = T_STEP / 2.0

# RK4 refinement: max log-pressure step per substep.  ln(1100/2.5) ~ 6.09
# total; 2e-3 per step keeps local truncation error far below fp32 epsilon.
MAX_DLOGP = 2e-3


def round_to(x, to, dp=2):
    """Round ``x`` to the nearest multiple of ``to``, then to ``dp`` decimal
    places (reference: modules/parcel_functions.py:358-362 — the table grid
    snapping helper)."""
    return jnp.round(jnp.round(jnp.asarray(x) / to) * to, dp)


def pressure_grid(dtype=jnp.float64):
    """The descending uniform pressure grid [1100, 1099.5, …, 2.5] hPa."""
    return jnp.asarray(np.round(np.arange(1100.0, 2.0, -0.5), 1), dtype=dtype)


def curve_start_temperatures(dtype=jnp.float64):
    """Start temperature (at 1100 hPa) of each of the 14,300 curves."""
    base = np.round(np.arange(T_MIN, T_MAX_EXCL, T_STEP), 2)
    starts = np.stack([base, base + CURVE_OFFSET], axis=1).reshape(-1)
    return jnp.asarray(starts, dtype=dtype)


def _refined_grid():
    """Static integration grid: the output pressure grid with each interval
    subdivided so every RK4 substep has |dlog p| <= MAX_DLOGP.

    Returns (log-pressure grid ascending in integration order (descending p),
    indices of the output pressures within it).  Host-side, static shapes.
    """
    p_out = np.round(np.arange(1100.0, 2.0, -0.5), 1)
    logp = np.log(p_out)
    pts = [logp[0]]
    out_idx = [0]
    for k in range(len(logp) - 1):
        a, b = logp[k], logp[k + 1]
        n_sub = max(1, int(np.ceil(abs(b - a) / MAX_DLOGP)))
        seg = np.linspace(a, b, n_sub + 1)[1:]
        pts.extend(seg.tolist())
        out_idx.append(len(pts) - 1)
    return np.asarray(pts), np.asarray(out_idx)


def rk4_step(logp, dlogp, t):
    """One RK4 step of dT/dlnp = p * moist_lapse_rate(p, T)."""
    def f(lp, tt):
        p = jnp.exp(lp)
        return p * moist_lapse_rate(p, tt)

    k1 = f(logp, t)
    k2 = f(logp + dlogp / 2, t + dlogp * k1 / 2)
    k3 = f(logp + dlogp / 2, t + dlogp * k2 / 2)
    k4 = f(logp + dlogp, t + dlogp * k3)
    return t + (dlogp / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


@functools.partial(jax.jit, static_argnames=('n_substeps',))
def integrate_between(t0, logp0, logp1, n_substeps=16):
    """Integrate T from log-pressure logp0 to logp1 with fixed RK4 substeps.

    Elementwise over arbitrary batch shapes; a zero interval is exact.
    """
    h = (logp1 - logp0) / n_substeps

    def body(i, t):
        return rk4_step(logp0 + i * h, h, t)

    return jax.lax.fori_loop(0, n_substeps, body, t0)


def generate_curves(dtype=jnp.float32):
    """Generate the full adiabat family on device via one lax.scan.

    Returns (N_CURVES, N_PRES): temperature of every curve at every output
    pressure.  The scan walks the statically refined log-pressure grid; the
    output grid points are gathered afterwards.
    """
    grid, out_idx = _refined_grid()
    grid = jnp.asarray(grid, dtype=dtype)
    t0 = curve_start_temperatures(dtype)

    def step(t, seg):
        lp0, lp1 = seg
        t_new = rk4_step(lp0, lp1 - lp0, t)
        return t_new, t_new

    segs = jnp.stack([grid[:-1], grid[1:]], axis=1)
    _, ts = jax.lax.scan(step, t0, segs)            # (n_steps, N_CURVES)
    all_t = jnp.concatenate([t0[None], ts], axis=0)  # include start point
    curves = all_t[jnp.asarray(out_idx)]             # (N_PRES, N_CURVES)
    return curves.T                                  # (N_CURVES, N_PRES)


def build_lookup(curves):
    """Build the (pressure, temperature) -> fractional curve index table.

    For each pressure-grid index the curve temperatures ``curves[:, ip]`` are
    strictly increasing in curve index (pseudoadiabats do not cross), so the
    curve passing exactly through a (p, T) cell has a well-defined fractional
    index by inverse interpolation.  This is the continuous refinement of the
    reference's two-pass nearest-curve rounding fill
    (reference: modules/parcel_functions.py:478-504): rounding the fractional
    index reproduces the reference's nearest-curve behaviour, while blending
    the two bracketing curves (the default consumer mode) removes the curve
    quantisation error entirely.  Cells outside the curve family's
    temperature envelope (beyond half a temperature step) are NaN (the
    reference leaves them NaN too; consumers re-NaN them).

    Returns float32 (N_PRES, N_TEMP).
    """
    tq = T_MIN + T_STEP * jnp.arange(N_TEMP, dtype=curves.dtype)

    def per_pressure(col):
        # col: (N_CURVES,) increasing curve temps at this pressure level.
        hi = jnp.clip(jnp.searchsorted(col, tq, side='left'), 1,
                      col.shape[0] - 1)
        lo = hi - 1
        frac = (tq - col[lo]) / (col[hi] - col[lo])
        fidx = lo + jnp.clip(frac, 0.0, 1.0)
        # Validity mirrors the reference's fill coverage: within half a
        # temperature step of the envelope.
        valid = ((tq >= col[0] - T_STEP / 2.0) &
                 (tq <= col[-1] + T_STEP / 2.0))
        return jnp.where(valid, fidx, jnp.nan).astype(jnp.float32)

    return jax.lax.map(per_pressure, curves.T, batch_size=128)


# Spectral curve representation: PIECEWISE Chebyshev coefficients of
# T(ln p) per curve.  Evaluating a blended coefficient row as vector
# arithmetic replaces per-level random gathers from the 126 MB curve table
# with one contiguous ~170 B row gather per column — the decisive
# optimisation for the profile hot path.
#
# Why piecewise: the curves' global Chebyshev convergence is slow
# (~0.80/term, basis-independent — ln p, Exner and theta-factored bases
# all measured identical, benchmarks/spectral_basis_study.py) because the
# pseudoadiabat has a migrating high-curvature locus (near the surface for
# cold curves, 50-300 hPa for warm ones).  A global fit needs K=48 for
# 1.2e-4 K; three segments split at 50 and 230 hPa reach 6.7e-5 K with 14
# terms each (benchmarks/spectral_piecewise_study.py).  In the fused
# kernel the evaluation costs (3 + N_SEG - 1) vector ops per term — the
# two extra selects pick each element's segment coefficient — so the
# Clenshaw block shrinks from ~149 to ~81 ops, ~12% of the whole
# VPU-issue-bound solve (results/op_mix_r4.json).
N_SEG = 3
SEG_K = 14
N_COEF = N_SEG * SEG_K
SEG_SPLITS = (50.0, 230.0)        # hPa, interior segment boundaries
_LNP_LO = float(np.log(P_BOT))
_LNP_HI = float(np.log(P_TOP))
# Ascending log-pressure segment bounds: segment 0 covers the lowest
# pressures, segment N_SEG-1 ends at P_TOP.
_SEG_LNP = (_LNP_LO,) + tuple(float(np.log(s)) for s in SEG_SPLITS) + \
    (_LNP_HI,)


def _cheb_nodes(n_coef, lo=_LNP_LO, hi=_LNP_HI):
    """Chebyshev-Gauss nodes mapped to [lo, hi] log-pressure, descending
    in p."""
    i = np.arange(n_coef)
    u = np.cos(np.pi * (i + 0.5) / n_coef)          # 1 -> -1
    lnp = 0.5 * (hi + lo) + 0.5 * (hi - lo) * u
    return u, lnp


def _cheb_transform_matrix(n_coef):
    """DCT matrix: coefficients = M @ values-at-Gauss-nodes."""
    i = np.arange(n_coef)
    k = i[:, None]
    M = (2.0 / n_coef) * np.cos(np.pi * k * (i + 0.5) / n_coef)
    M[0] *= 0.5
    return M


def build_spectral(dtype=jnp.float32, seg_k=SEG_K, n_substeps=64):
    """Chebyshev-fit every curve per segment by integrating the ODE through
    the union of all segments' Gauss nodes (no resampling error from the
    0.5 hPa grid) and transforming on the MXU.

    Returns (N_CURVES, N_SEG * seg_k): segment 0 (lowest pressures) first,
    each segment's ``seg_k`` coefficients contiguous.
    """
    per_seg = [_cheb_nodes(seg_k, _SEG_LNP[s], _SEG_LNP[s + 1])[1]
               for s in range(N_SEG)]
    lnp_nodes = np.concatenate(per_seg)
    order = np.argsort(-lnp_nodes)                  # integrate descending p
    lnp_sorted = lnp_nodes[order]
    t0 = curve_start_temperatures(dtype)

    segs = jnp.asarray(
        np.stack([np.concatenate([[np.log(P_TOP)], lnp_sorted[:-1]]),
                  lnp_sorted], axis=1), dtype)

    def step(t, seg):
        t_new = integrate_between(t, seg[0], seg[1], n_substeps=n_substeps)
        return t_new, t_new

    _, t_sorted = jax.lax.scan(step, t0, segs)      # (nodes, N_CURVES)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    t_nodes = t_sorted[jnp.asarray(inv)]            # original node order
    M = jnp.asarray(_cheb_transform_matrix(seg_k), dtype)
    coeffs = [jnp.matmul(M, t_nodes[s * seg_k:(s + 1) * seg_k],
                         precision='highest').T
              for s in range(N_SEG)]
    return jnp.concatenate(coeffs, axis=-1).astype(dtype)


def _eval_spectral(coeffs, pressure, log_pressure=None, axis=-1):
    """Piecewise-Clenshaw evaluation of per-column segment-Chebyshev
    coefficients (…, N_SEG*seg_k) at per-level pressures (…, L) — pure
    elementwise arithmetic (each term: one select per interior boundary to
    pick the element's segment coefficient, plus the usual mul/add/sub)
    that XLA fuses.
    ``log_pressure``: optional precomputed ``log(pressure)``.
    ``axis``: level axis of ``pressure``; with ``axis == 0`` (level-major
    arrays) ``coeffs`` is (K, …batch) and ``pressure`` (L, …batch), and
    coefficient k broadcasts natively."""
    lnp = log_pressure if log_pressure is not None else jnp.log(pressure)
    if axis == -1:
        coef = lambda k: coeffs[..., k:k + 1]
        K_tot = coeffs.shape[-1]
    else:
        coef = lambda k: coeffs[k]
        K_tot = coeffs.shape[0]
    seg_k = K_tot // N_SEG
    assert seg_k * N_SEG == K_tot, (K_tot, N_SEG)

    # Segment membership masks (N_SEG - 1 compares) and the per-element
    # affine map to the segment's [-1, 1].  Constant divisors folded to
    # multiplies at trace time (a divide costs several multiplies).
    in_low = [lnp < _SEG_LNP[s + 1] for s in range(N_SEG - 1)]

    def select_seg(values):
        # values[s] per segment; nested float-operand selects, innermost
        # segment last (elements below split s take values[s]).
        out = values[N_SEG - 1]
        for s in range(N_SEG - 2, -1, -1):
            out = jnp.where(in_low[s], values[s], out)
        return out

    scales = [2.0 / (_SEG_LNP[s + 1] - _SEG_LNP[s]) for s in range(N_SEG)]
    shifts = [(_SEG_LNP[s + 1] + _SEG_LNP[s]) /
              (_SEG_LNP[s + 1] - _SEG_LNP[s]) for s in range(N_SEG)]
    dt = jnp.asarray(lnp).dtype
    scale = select_seg([jnp.asarray(s, dt) for s in scales])
    shift = select_seg([jnp.asarray(s, dt) for s in shifts])
    u = jnp.clip(lnp * scale - shift, -1.0, 1.0)

    def seg_coef(k):
        return select_seg([coef(s * seg_k + k) for s in range(N_SEG)])

    b1 = jnp.zeros_like(u)
    b2 = jnp.zeros_like(u)
    two_u = 2.0 * u
    for k in range(seg_k - 1, 0, -1):
        b1, b2 = seg_coef(k) + two_u * b1 - b2, b1
    return seg_coef(0) + u * b1 - b2


def _save_npz(path, curves, lookup, coeffs):
    """Atomic compressed save from HOST arrays.

    Atomic because the write takes minutes on a 1-core host and may target
    an existing valid cache (the stale-coeffs refresh) — an interrupt
    mid-write must never leave a corrupt npz behind.  PID-unique temp
    name: concurrent savers must not share a temp inode.  Host arrays so
    refresh paths that already hold the decompressed copies don't round-
    trip ~190 MB through a slow device->host link.
    """
    tmp = f'{path}.{os.getpid()}.tmp'
    arrays = {'curves': curves, 'lookup': lookup}
    if coeffs is not None:
        arrays['coeffs'] = coeffs
    try:
        with open(tmp, 'wb') as f:   # handle: savez cannot append .npz
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class AdiabatTables:
    """Device-resident moist-adiabat tables (a pytree of three arrays).

    ``curves``: (N_CURVES, N_PRES) float — curve temperature by pressure
    (dense grid; used by the reference-faithful nearest modes and the
    pointwise wet-bulb path).
    ``lookup``: (N_PRES, N_TEMP) float32 — fractional curve index at a (p, T)
    cell, NaN where no curve passes.
    ``coeffs``: (N_CURVES, N_COEF) float — piecewise Chebyshev
    coefficients of T(ln p) per curve, N_SEG segments of SEG_K terms
    each (the profile hot path).
    """

    def __init__(self, curves, lookup, coeffs=None):
        self.curves = curves
        self.lookup = lookup
        self.coeffs = coeffs
        # A legacy pre-piecewise global-fit table (e.g. K=48) would pass
        # the divisibility assert in _eval_spectral (48 = 3*16) and be
        # evaluated as three independent 16-term segment series — garbage
        # temperatures with no error.  Warn at construction; loaders
        # rebuild stale layouts automatically, this catches tables built
        # or threaded by hand.  (Guarded attribute access: tree_unflatten
        # may pass non-array sentinels during jax tree operations.)
        width = getattr(coeffs, 'shape', (N_COEF,))[-1:]
        if width and isinstance(width[0], int) and width[0] != N_COEF:
            warnings.warn(
                f'AdiabatTables.coeffs has width {width[0]}, not the '
                f'piecewise layout N_SEG*SEG_K={N_COEF}; a pre-piecewise '
                f'global-fit table will produce wrong temperatures — '
                f'rebuild with AdiabatTables.build()/load().')

    def tree_flatten(self):
        return (self.curves, self.lookup, self.coeffs), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def build(cls, dtype=jnp.float32):
        curves = generate_curves(dtype=dtype)
        return cls(curves, build_lookup(curves), build_spectral(dtype=dtype))

    def astype(self, dtype):
        return AdiabatTables(self.curves.astype(dtype), self.lookup,
                             None if self.coeffs is None
                             else self.coeffs.astype(dtype))

    def save(self, path):
        # Spectral-less tables (coeffs=None is a legal constructor state)
        # save without the key; load() rebuilds the coefficients.
        _save_npz(path, np.asarray(self.curves), np.asarray(self.lookup),
                  None if self.coeffs is None else np.asarray(self.coeffs))

    @classmethod
    def load(cls, path, dtype=None):
        with np.load(path) as f:
            arrays = {k: np.asarray(f[k]) for k in f.files}
        return cls._from_arrays(arrays, dtype=dtype)

    @classmethod
    def _from_arrays(cls, arrays, dtype=None):
        """Build from a dict of host arrays (one npz decompression —
        callers that also inspect dtype/staleness reuse the same dict)."""
        curves = arrays['curves']
        lookup = arrays['lookup']
        coeffs = arrays.get('coeffs')
        # A cache built under a different spectral representation
        # (e.g. the pre-piecewise global K=48 fit) keeps its curves and
        # lookup — those are representation-independent — but its
        # coefficients are rebuilt (seconds of CPU scan work).
        if coeffs is not None and coeffs.shape[-1] != N_COEF:
            coeffs = None
        if dtype is not None:
            curves = curves.astype(dtype)
            coeffs = None if coeffs is None else coeffs.astype(dtype)
        if coeffs is None:
            coeffs = build_spectral(dtype=dtype or curves.dtype)
        return cls(jnp.asarray(curves), jnp.asarray(lookup),
                   jnp.asarray(coeffs))


jax.tree_util.register_pytree_node_class(AdiabatTables)

# Module-level default tables — API parity with the reference's
# load_moist_adiabat_lookups/module singletons (reference:
# modules/parcel_functions.py:18-61), but functions also accept explicit
# tables for jit-friendly threading.
_DEFAULT_TABLES = None
_DEFAULT_SOURCE = None
_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'adiabat_lookups')


def _stored_dtype(path):
    """Dtype of the cached curves array from the .npy header alone — no
    decompression of the ~100 MB member (NpzFile.__getitem__ would
    materialise it).  None when the file is unreadable/not a table cache."""
    import zipfile

    from numpy.lib import format as npformat
    try:
        with zipfile.ZipFile(path) as z, z.open('curves.npy') as f:
            version = npformat.read_magic(f)
            if version == (1, 0):
                _, _, dtype = npformat.read_array_header_1_0(f)
            else:
                _, _, dtype = npformat.read_array_header_2_0(f)
            return dtype
    except (KeyError, OSError, ValueError, zipfile.BadZipFile):
        return None


def load_moist_adiabat_lookups(cache_path=None, regenerate=False,
                               dtype=None):
    """Load (or build and cache) the default adiabat tables.

    The cache is keyed by dtype (``adiabat_tables_f32.npz`` /
    ``_f64.npz``) so an fp32-built cache is never silently served to an
    fp64 validation session; a cache of wider dtype is downcast, a
    narrower one is rebuilt.

    When an explicit ``cache_path`` (or ``XPARCEL_TPU_TABLE_CACHE``) holds
    insufficient precision, the dtype-keyed default path is consulted as a
    fallback load candidate, and rebuilt tables are saved there rather
    than overwriting the explicit cache.

    Caches whose spectral-coefficient layout is stale (a pre-piecewise
    global fit) rebuild the coefficients on load; MANAGED caches (under
    the package's ``adiabat_lookups/``) are then refreshed on disk —
    in place for a same-dtype cache, to the dtype-keyed default path for
    a wider one.  An explicit user cache is never rewritten: a stale
    explicit cache pays the in-process rebuild every load (re-save it
    once via ``AdiabatTables.save`` to upgrade it deliberately).
    """
    global _DEFAULT_TABLES, _DEFAULT_SOURCE
    desired = jnp.dtype(dtype or (jnp.float64 if jax.config.jax_enable_x64
                                  else jnp.float32))
    suffix = 'f64' if desired.itemsize == 8 else 'f32'
    default_path = os.path.join(_CACHE_DIR, f'adiabat_tables_{suffix}.npz')
    path = cache_path or os.environ.get('XPARCEL_TPU_TABLE_CACHE',
                                        default_path)
    # Resident tables are reused only when they came from the same resolved
    # source (a later call with a different cache_path/env must re-load).
    if (not regenerate and _DEFAULT_TABLES is not None and
            _DEFAULT_SOURCE == path and
            _DEFAULT_TABLES.curves.dtype == desired):
        return _DEFAULT_TABLES
    # Migration/widening: accept any cache whose stored precision covers
    # the request (downcasting is exact; upcasting would fake precision).
    # An explicit path is preferred, but the dtype-keyed default remains a
    # fallback candidate: an insufficient-precision explicit cache must not
    # force a rebuild on every call/process (the rebuilt tables live at the
    # default path, see below).
    if cache_path or 'XPARCEL_TPU_TABLE_CACHE' in os.environ:
        candidates = [path, default_path]
    else:
        candidates = [
            path, os.path.join(_CACHE_DIR, 'adiabat_tables_f64.npz'),
            os.path.join(_CACHE_DIR, 'adiabat_tables.npz')]
    if not regenerate:
        for cand in candidates:
            if not os.path.exists(cand):
                continue
            # Cheap header-only dtype check BEFORE decompressing ~275 MB:
            # an insufficient-precision candidate is skipped without
            # materialising its arrays.
            stored = _stored_dtype(cand)
            if stored is None or stored.itemsize < desired.itemsize:
                continue
            # One decompression per accepted candidate: staleness check
            # and table construction share the same arrays.
            with np.load(cand) as f:
                arrays = {k: np.asarray(f[k]) for k in f.files}
            stale_coeffs = ('coeffs' not in arrays or
                            arrays['coeffs'].shape[-1] != N_COEF)
            _DEFAULT_TABLES = AdiabatTables._from_arrays(arrays,
                                                         dtype=desired)
            # Persist the rebuilt representation so later processes load
            # it directly: a same-dtype managed cache is refreshed in
            # place; a WIDER stored cache serving a narrower request must
            # never be overwritten with narrowed tables — the narrowed
            # rebuild goes to the dtype-keyed default path instead
            # (otherwise every narrow process rebuilds forever).  The
            # refresh is an optimisation: a read-only cache dir must not
            # turn a successful in-memory load into a crash.
            if (stale_coeffs and
                    os.path.dirname(os.path.abspath(cand)) == _CACHE_DIR):
                target = cand if stored == desired else default_path
                try:
                    coeffs_host = np.asarray(_DEFAULT_TABLES.coeffs)
                    if stored == desired:
                        cur, look = arrays['curves'], arrays['lookup']
                    else:
                        cur = arrays['curves'].astype(desired)
                        look = arrays['lookup']
                    _save_npz(target, cur, look, coeffs_host)
                except OSError as e:
                    warnings.warn(f'could not refresh table cache '
                                  f'{target!r}: {e}')
            _DEFAULT_SOURCE = path
            return _DEFAULT_TABLES
    _DEFAULT_TABLES = AdiabatTables.build(dtype=desired)
    # The resident-tables key stays the RESOLVED path so the next in-process
    # call with the same cache settings hits the resident check.
    _DEFAULT_SOURCE = path
    save_path = path
    explicit = cache_path or os.environ.get('XPARCEL_TPU_TABLE_CACHE')
    if (explicit and os.path.exists(path) and not regenerate and
            path != default_path):
        # A user-supplied cache of insufficient precision is never silently
        # overwritten; the rebuilt tables go to the dtype-keyed default path
        # (which is also a load candidate above, so later processes with the
        # same explicit cache load it instead of rebuilding).  An "explicit"
        # path that IS the dtype-keyed default is just the default cache —
        # plain overwrite, no redirect, no warning.
        warnings.warn(
            f'table cache {path!r} holds {_stored_dtype(path)} but '
            f'{desired} was requested; rebuilt tables cached at '
            f'{default_path!r} instead (pass regenerate=True to overwrite)')
        save_path = default_path
    if os.path.dirname(save_path):   # bare filename -> current directory
        os.makedirs(os.path.dirname(save_path), exist_ok=True)
    _DEFAULT_TABLES.save(save_path)
    return _DEFAULT_TABLES


def default_tables():
    if _DEFAULT_TABLES is None:
        raise RuntimeError('Call load_moist_adiabat_lookups() first, or pass '
                           'tables= explicitly.')
    return _DEFAULT_TABLES


def curve_index_integrate(parcel_pressure, parcel_temperature,
                          n_substeps=12):
    """Fractional curve index by *backward ODE integration* — gather-free.

    The curve family is parametrised by its start temperature at 1100 hPa on
    a uniform 0.01 K grid (reference: modules/parcel_functions.py:469-476),
    so "which adiabat passes through (p, T)" is answered exactly by
    integrating the pseudoadiabat ODE from (p, T) back up to 1100 hPa:
    fidx = (T_start - 173 K) / 0.01 K.  This replaces the reference's 15.7M-
    cell (pressure, temperature) -> index lookup table in the hot path: four
    random scalar gathers per column become ~100 elementwise flops per
    column, and the result is *more* accurate than any table
    interpolation.  Parcel states live near 1000 hPa, so the backward
    leg is short (|dln p| ~ 0.1) and RK4 with fixed substeps is exact to
    fp32: 12 substeps sit within 3.6e-4 index units (3.6e-6 K) of a
    192-substep run over the full envelope (450-1090 hPa, 210-315 K) —
    20x below the spectral fit's own 6.7e-5 K accuracy floor; every
    substep is 4 sequential O(B) evaluations in the solve's pre-pass.

    NaN/envelope semantics match the table consumer: NaN state or a start
    temperature outside the curve family -> NaN.
    """
    pp = jnp.asarray(parcel_pressure)
    pt = jnp.asarray(parcel_temperature)
    valid = notnan(pp) & notnan(pt) & (pp > 0)
    lp0 = jnp.log(jnp.where(valid, pp, P_TOP))
    t0 = jnp.where(valid, pt, 273.15)
    t_start = integrate_between(t0, lp0, jnp.full_like(lp0, _LNP_HI),
                                n_substeps=n_substeps)
    spacing = T_STEP / 2.0            # 0.01 K between consecutive curves
    fidx = (t_start - T_MIN) / spacing
    # Envelope: the lookup-table fill accepts states within half a
    # TEMPERATURE-AXIS cell (T_STEP/2 = one curve spacing = 1.0 in index
    # units) of the family, so the same tolerance applies here — a
    # half-INDEX tolerance (0.005 K) would flip near-envelope parcels
    # between NaN and finite depending on index_mode.
    ok = valid & (fidx >= -1.0) & (fidx <= N_CURVES)
    return jnp.where(ok, jnp.clip(fidx, 0.0, N_CURVES - 1.0), jnp.nan)


def _curve_index(tables, parcel_pressure, parcel_temperature,
                 bilinear=True):
    """Fractional curve index for a parcel state.

    With ``bilinear`` (default) the fractional index is bilinearly
    interpolated over the four neighbouring (p, T) cells, removing the cell
    quantisation of the reference's nearest ``.sel`` (reference:
    modules/parcel_functions.py:554-557); otherwise the nearest cell is used
    (clamped at grid edges, like xarray nearest-sel).  Returns NaN where the
    parcel is outside the table envelope.
    """
    fp_ = (P_TOP - parcel_pressure) / P_STEP
    ft = (parcel_temperature - T_MIN) / T_STEP
    if not bilinear:
        ip = jnp.clip(jnp.round(fp_), 0, N_PRES - 1).astype(jnp.int32)
        it = jnp.clip(jnp.round(ft), 0, N_TEMP - 1).astype(jnp.int32)
        return tables.lookup[ip, it]

    ip0 = jnp.clip(jnp.floor(fp_), 0, N_PRES - 2).astype(jnp.int32)
    it0 = jnp.clip(jnp.floor(ft), 0, N_TEMP - 2).astype(jnp.int32)
    ap = jnp.clip(fp_ - ip0, 0.0, 1.0)
    at = jnp.clip(ft - it0, 0.0, 1.0)
    f00 = tables.lookup[ip0, it0]
    f01 = tables.lookup[ip0, it0 + 1]
    f10 = tables.lookup[ip0 + 1, it0]
    f11 = tables.lookup[ip0 + 1, it0 + 1]
    bil = ((1 - ap) * ((1 - at) * f00 + at * f01) +
           ap * ((1 - at) * f10 + at * f11))
    # Fall back to the nearest cell when a corner is outside the envelope.
    ipn = jnp.clip(jnp.round(fp_), 0, N_PRES - 1).astype(jnp.int32)
    itn = jnp.clip(jnp.round(ft), 0, N_TEMP - 1).astype(jnp.int32)
    nearest = tables.lookup[ipn, itn]
    return jnp.where(jnp.isnan(bil), nearest, bil)


def _interp_curve(tables, fidx, pressure, curve_blend=True):
    """Evaluate the adiabat with fractional index ``fidx`` at ``pressure`` —
    pure index arithmetic on the uniform grids (the reference needed a numba
    gufunc plus xarray gathers here).

    With ``curve_blend`` the two bracketing curves are linearly blended by
    the fractional part; otherwise the nearest curve alone is used
    (reference-faithful nearest behaviour).
    """
    fi = (P_TOP - pressure) / P_STEP
    i0 = jnp.clip(jnp.floor(fi), 0, N_PRES - 2).astype(jnp.int32)
    t = fi - i0
    if fidx.ndim < pressure.ndim:
        fidx = fidx[..., None]
    if curve_blend:
        c0 = jnp.clip(jnp.floor(fidx), 0, N_CURVES - 2).astype(jnp.int32)
        a = jnp.clip(fidx - c0, 0.0, 1.0)
        lo = (tables.curves[c0, i0] * (1.0 - t) +
              tables.curves[c0, i0 + 1] * t)
        hi = (tables.curves[c0 + 1, i0] * (1.0 - t) +
              tables.curves[c0 + 1, i0 + 1] * t)
        return lo * (1.0 - a) + hi * a
    idx = jnp.clip(jnp.round(fidx), 0, N_CURVES - 1).astype(jnp.int32)
    return tables.curves[idx, i0] * (1.0 - t) + tables.curves[idx, i0 + 1] * t


def blend_coeff_rows(tables, fidx):
    """Blend the two spectral coefficient rows bracketing fractional curve
    index ``fidx`` (…,) into one (…, K) row per column — one contiguous
    row-pair gather, zero per-level gathers.

    NaN ``fidx`` (invalid parcel) yields an all-NaN row; the arithmetic
    itself runs on a zeroed safe index so no NaN enters a product (the
    where-NaN gradient trap).  The single source of truth for the blend:
    both ``moist_lapse``'s spectral branch and the fused kernel's XLA
    pre-pass (fused.py) call this.
    """
    nan = jnp.isnan(fidx)
    safe = jnp.where(nan, 0.0, fidx)
    c0 = jnp.clip(jnp.floor(safe), 0, N_CURVES - 2).astype(jnp.int32)
    a = jnp.clip(safe - c0, 0.0, 1.0)[..., None]
    row = tables.coeffs[c0] * (1.0 - a) + tables.coeffs[c0 + 1] * a
    return jnp.where(nan[..., None], jnp.nan, row)


def moist_lapse(pressure, parcel_temperature, parcel_pressure=None,
                tables=None, bilinear=True, curve_blend=True,
                index_mode=None, pointwise=None):
    """Temperature of parcels lifted moist-adiabatically, via lookup tables.

    ``pressure``: (…, L) levels to lift to (or (…) for pointwise use);
    ``parcel_temperature`` / ``parcel_pressure``: (…) parcel start state
    (parcel_pressure defaults to the first level,
    reference: modules/parcel_functions.py:549-550).

    ``pointwise``: every point is its own parcel (pressure and parcel
    state share one shape) instead of lifting each parcel along a level
    axis.  Default None auto-detects by exact shape equality — ambiguous
    only for 1-D profile calls whose batch equals the level count, so
    library call sites pass it explicitly; a moist-lapse backend must
    accept this keyword.

    ``index_mode`` selects how the parcel state maps to a curve index:
    ``'integrate'`` (default — gather-free backward ODE integration, see
    ``curve_index_integrate``), ``'bilinear'`` (lookup-table cells,
    bilinearly interpolated) or ``'nearest'`` (the reference-faithful
    nearest-cell ``.sel``).  ``curve_blend`` (default on) blends the two
    bracketing curves by the fractional index; off = nearest curve only,
    as the reference.  ``bilinear=False`` is a back-compat alias for
    ``index_mode='nearest'``.

    NaN-faithful to the reference (:570-605): invalid parcels, out-of-table
    parcels, and out-of-range level pressures all give NaN.
    """
    if tables is None:
        tables = default_tables()
    pressure = jnp.asarray(pressure)
    if pointwise is None:
        # Exact-shape match, not ndim match: a shared 1-D level vector with
        # batched parcels is a PROFILE call (broadcast to (B, L)), not a
        # pointwise one.
        pointwise = parcel_temperature is not None and (
            jnp.shape(parcel_temperature) == pressure.shape)
    if parcel_pressure is None:
        # Pointwise mode: every point is its own parcel start.
        parcel_pressure = pressure if pointwise else pressure[..., 0]
    parcel_temperature = jnp.asarray(parcel_temperature)
    parcel_pressure = jnp.asarray(parcel_pressure)
    if not pointwise:
        # A shared level vector with batched parcels broadcasts to the full
        # (batch, L) lift — the curve-gather indexing below needs the
        # explicit shape, and 'as in cape.cape_cin' this combination is
        # part of the public contract.
        batch = jnp.broadcast_shapes(parcel_temperature.shape,
                                     parcel_pressure.shape,
                                     pressure.shape[:-1])
        pressure = jnp.broadcast_to(pressure, batch + pressure.shape[-1:])

    if index_mode is None:
        index_mode = 'integrate' if bilinear else 'nearest'
    if index_mode == 'integrate':
        fidx = curve_index_integrate(parcel_pressure, parcel_temperature)
    else:
        fidx = _curve_index(tables, parcel_pressure, parcel_temperature,
                            bilinear=index_mode == 'bilinear')
    valid = notnan(fidx) & notnan(parcel_temperature) & \
        notnan(parcel_pressure)
    fidx = jnp.where(valid, fidx, 0.0).astype(tables.curves.dtype)

    safe_p = jnp.where(jnp.isnan(pressure), P_TOP, pressure)
    spectral = (curve_blend and not pointwise
                and getattr(tables, 'coeffs', None) is not None)
    if spectral:
        out = _eval_spectral(blend_coeff_rows(tables, fidx), safe_p)
    elif pointwise:
        out = _interp_curve(tables, fidx[..., None], safe_p[..., None],
                            curve_blend=curve_blend)[..., 0]
    else:
        out = _interp_curve(tables, fidx, safe_p, curve_blend=curve_blend)

    in_range = (pressure >= P_BOT) & (pressure <= P_TOP)
    ok = in_range & notnan(pressure)
    if not pointwise:
        ok = ok & valid[..., None]
    else:
        ok = ok & valid
    return jnp.where(ok, out, jnp.nan)


def moist_lapse_integrate(pressure, parcel_temperature, parcel_pressure=None,
                          n_substeps=32, tables=None, pointwise=None):
    """Direct RK4 integration per query — the accuracy oracle.

    Walks the requested levels sequentially from the parcel state (level to
    level along the same pseudoadiabat), NaN-skipping, like MetPy's odeint
    path that the reference monkeypatches in for exact unit testing
    (reference: modules/unit_tests.py:114-140).  ``tables`` is accepted and
    ignored so it is signature-compatible with ``moist_lapse``; so is
    ``pointwise`` (see there — default auto-detects by exact shape
    equality).
    """
    pressure = jnp.asarray(pressure)
    if pointwise is None:
        pointwise = parcel_temperature is not None and (
            jnp.shape(parcel_temperature) == pressure.shape)
    if pointwise:
        levels = pressure[..., None]
    else:
        levels = pressure
    if parcel_pressure is None:
        parcel_pressure = levels[..., 0]
    batch = jnp.broadcast_shapes(jnp.shape(parcel_temperature),
                                 jnp.shape(parcel_pressure),
                                 levels.shape[:-1])
    t0 = jnp.broadcast_to(jnp.asarray(parcel_temperature, levels.dtype),
                          batch).astype(levels.dtype)
    p0 = jnp.broadcast_to(jnp.asarray(parcel_pressure, levels.dtype),
                          batch).astype(levels.dtype)
    levels = jnp.broadcast_to(levels, batch + levels.shape[-1:])

    start_valid = notnan(t0) & notnan(p0)
    lp0 = jnp.log(jnp.where(start_valid, p0, P_TOP))
    t_start = jnp.where(start_valid, t0, 273.15)

    def step(carry, p_k):
        t_cur, lp_cur = carry
        valid = notnan(p_k) & (p_k > 0)
        lp_new = jnp.where(valid, jnp.log(jnp.where(valid, p_k, 1.0)), lp_cur)
        t_new = integrate_between(t_cur, lp_cur, lp_new,
                                  n_substeps=n_substeps)
        out = jnp.where(valid, t_new, jnp.nan)
        return (t_new, lp_new), out

    (_, _), outs = jax.lax.scan(step, (t_start, lp0),
                                jnp.moveaxis(levels, -1, 0))
    out = jnp.moveaxis(outs, 0, -1)
    out = jnp.where(start_valid[..., None], out, jnp.nan)
    if pointwise:
        out = out[..., 0]
    return out
