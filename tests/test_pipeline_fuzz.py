"""Randomized differential sweep: full conv_properties vs the serial oracle
on adversarial grids.

The multicross fuzz targets lfc_el; this sweep drives the WHOLE
``pipeline.conv_properties`` variable set, per seeded adversarial grid
class, against the independent SciPy serial oracle (the reference's
acceptance surface, reference: modules/parcel_test.py:276-414):

- ``dup_pressure``   — repeated pressure levels (duplicate-aware interp,
                       zero-width crossing gaps)
- ``interior_nan``   — whole-level NaN runs inside the column.  The vector
                       side computes NaN-faithfully on the fixed shape and
                       is reference-faithful in SKIPPING gap areas and
                       in-gap crossings (reference trapz :164-206 /
                       find_intersections are per-adjacent-pair); the
                       oracle sees the dropna'd column, which BRIDGES the
                       gap — so runs intersecting the integration windows
                       are filtered from the cape/cin comparison, and the
                       sweep pins agreement everywhere else
- ``near_envelope``  — parcels launched ~saturated (dewpoint depression
                       0.01-0.5 K at the surface: LCL hugs the launch
                       level, crossings crowd the profile bottom)
- ``deep_depression``— 9-15 K surface depressions (LCL 150-250 hPa above
                       the surface: exclusion/substitution rules active)

Every oracle-covered variable must agree within the established tier-2
tolerances on same-branch, same-parcel columns, and the branch filters
must keep a real fraction of each grid (no vacuous pass).  The same
harness was run exploratorily over 210 HELD-OUT seeded grids — seeds
500-509 + 600-619 on the base climate, plus 60 grids in cold-stable and
tropical-moist regimes (seeds 700-705; 1,198 of their comparable columns
sit in the zero-CAPE/no-LFC substitution-rule branch the base climate
rarely hits) — 6,761 comparable variant-columns, zero deviations
(round-5 logs).

The vector side runs the production ``conv_properties`` itself (exact-ODE
moist-lapse backend for logic-identity with the oracle's solve_ivp), with
the oracle fed the PIPELINE's own derived dewpoint so both sides ascend
identical parcels (the MetPy RH chain q->Td is not an exact inverse).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import adiabat, pipeline, parcels, thermo

import serial_oracle as oracle
from test_integration_serial import make_grid

ML = dict(moist_lapse=adiabat.moist_lapse_integrate)
N, L = 12, 48
CASES = ('dup_pressure', 'interior_nan', 'near_envelope',
         'deep_depression', 'combined')


def _mutate(case, p, t, td, rng):
    if case == 'dup_pressure':
        # 1-3 duplicated interior pressure levels per column.
        for j in range(p.shape[0]):
            for k in rng.choice(np.arange(4, L - 6), rng.integers(1, 4),
                                replace=False):
                p[j, k + 1] = p[j, k]
        p[:] = -np.sort(-p, axis=-1)
    elif case == 'interior_nan':
        # Whole-level NaN runs (2-4 consecutive levels) in 2/3 of columns.
        # Mostly high in the column (above the typical EL): the vector side
        # is reference-faithful in SKIPPING areas across NaN gaps
        # (reference trapz :164-206 rolling pairs, NaN -> excluded) while
        # the dropna oracle BRIDGES them, so runs intersecting the
        # integration windows are legitimately incomparable and get
        # filtered; a couple of low runs exercise that filter.
        for j in range(p.shape[0]):
            if j % 3 == 2:
                continue
            k = int(rng.integers(5, 12) if j in (1, 4)
                    else rng.integers(34, L - 8))
            w = int(rng.integers(2, 5))
            p[j, k:k + w] = t[j, k:k + w] = td[j, k:k + w] = np.nan
    elif case == 'near_envelope':
        depr = rng.uniform(0.01, 0.5, p.shape[0])
        td[:, 0] = t[:, 0] - depr
        td[:, 1] = np.minimum(td[:, 1], td[:, 0])
    elif case == 'deep_depression':
        depr = rng.uniform(9.0, 15.0, p.shape[0])
        td[:, 0] = t[:, 0] - depr
        # Drying continues above so the surface stays the launch candidate.
        td[:, 1:6] = np.minimum(td[:, 1:6], (td[:, 0] - 1.0)[:, None])
    elif case == 'combined':
        # All three adversarial features on one grid (a third of the
        # columns each) — interactions between the mutation classes.
        for j in range(p.shape[0]):
            if j % 3 == 0:
                k = int(rng.integers(4, L - 6))
                p[j, k + 1] = p[j, k]
            elif j % 3 == 1:
                k = int(rng.integers(34, L - 8))
                w = int(rng.integers(2, 5))
                p[j, k:k + w] = t[j, k:k + w] = td[j, k:k + w] = np.nan
            else:
                td[j, 0] = t[j, 0] - float(rng.uniform(9.0, 15.0))
                td[j, 1:6] = np.minimum(td[j, 1:6], td[j, 0] - 1.0)
        for j in range(0, p.shape[0], 3):
            p[j] = -np.sort(-p[j])
    return p, t, td


@pytest.fixture(scope='module', params=CASES)
def sweep(request):
    case = request.param
    seed = 400 + CASES.index(case)
    rng = np.random.default_rng(seed)
    p, t, td0 = (v[0].copy() for v in make_grid(ny=1, nx=N, L=L, seed=seed))
    p, t, td0 = _mutate(case, p, t, td0, rng)

    h = 44330.0 * (1.0 - (np.where(np.isnan(p), 500.0, p)
                          / 1013.25) ** 0.19)
    h = np.where(np.isnan(p), np.nan, h)
    winds = {
        'surface_wind_u': rng.normal(3, 2, (N,)),
        'surface_wind_v': rng.normal(0, 2, (N,)),
        'wind_u': rng.normal(8, 5, (N, L)),
        'wind_v': rng.normal(2, 5, (N, L)),
        'wind_height_above_surface': np.broadcast_to(
            np.linspace(0.0, 16000.0, L), (N, L)).copy(),
    }

    # Feed the oracle the pipeline's own derived dewpoint (identical
    # parcels on both sides; the RH-route q->Td chain is not exact).
    q = np.asarray(jax.jit(thermo.specific_humidity_from_dewpoint)(
        jnp.asarray(p), jnp.asarray(td0)))
    td = np.asarray(jax.jit(thermo.dewpoint_from_specific_humidity)(
        jnp.asarray(p), jnp.asarray(t), jnp.asarray(q)))

    dat = {'pressure': jnp.asarray(p), 'temperature': jnp.asarray(t),
           'specific_humidity': jnp.asarray(q), 'height_asl': jnp.asarray(h),
           **{k: jnp.asarray(v) for k, v in winds.items()}}

    def run(dat):
        out = dict(pipeline.conv_properties(dat, ignore_nans=True, **ML))
        # Branch/parcel probes for the comparison filters (lfc per variant,
        # the MU launch pressure) — conv_properties itself does not expose
        # them.
        pp = dat['pressure']
        tt = dat['temperature']
        dew = thermo.dewpoint_from_specific_humidity(
            pp, tt, dat['specific_humidity'])
        _, mu_prof, mu_parcel = parcels.most_unstable_cape_cin(
            pp, tt, dew, depth=250.0, **ML)
        _, m100_prof, _ = parcels.mixed_layer_cape_cin(pp, tt, dew,
                                                       depth=100.0, **ML)
        _, m50_prof, _ = parcels.mixed_layer_cape_cin(pp, tt, dew,
                                                      depth=50.0, **ML)
        for nm, pr in (('mu', mu_prof), ('m100', m100_prof),
                       ('m50', m50_prof)):
            out[f'_{nm}_lfc'] = pr['lfc_pressure']
            out[f'_{nm}_el'] = pr['el_pressure']
        out['_mu_parcel_pressure'] = mu_parcel['pressure']
        return out

    vec = {k: np.asarray(v) for k, v in jax.jit(run)(dat).items()}

    ser = {}
    keys = [f'{n}_{v}' for n in ('mu', 'm100', 'm50')
            for v in ('cape', 'cin', 'lfc', 'el', 'li', 'dci')]
    keys += ['mu_parcel_pressure', 'lapse', 't500', 'flh', 'mlh',
             'shear_u', 'shear_v', 'shear_magnitude']
    for k in keys:
        ser[k] = np.full((N,), np.nan)
    for j in range(N):
        keep = ~np.isnan(p[j])          # dropna = the oracle's semantics
        pc, tc, tdc, hc = p[j][keep], t[j][keep], td[j][keep], h[j][keep]
        mu = oracle.most_unstable_cape_cin_column(pc, tc, tdc, depth=250.0)
        m100 = oracle.mixed_layer_cape_cin_column(pc, tc, tdc, depth=100.0)
        m50 = oracle.mixed_layer_cape_cin_column(pc, tc, tdc, depth=50.0)
        ser['mu_parcel_pressure'][j] = mu['parcel_pressure']
        for name, res in (('mu', mu), ('m100', m100), ('m50', m50)):
            li = oracle.lifted_index_column(res)
            ser[f'{name}_cape'][j] = res['cape']
            ser[f'{name}_cin'][j] = res['cin']
            ser[f'{name}_lfc'][j] = res['lfc']
            ser[f'{name}_el'][j] = res['el']
            ser[f'{name}_li'][j] = li
            ser[f'{name}_dci'][j] = oracle.dci_column(pc, tc, tdc, li)
        ser['lapse'][j] = oracle.lapse_rate_column(pc, tc, hc)
        ser['t500'][j] = oracle.isobar_temperature_column(pc, tc)
        ser['flh'][j] = oracle.freezing_level_height_column(tc, hc)
        ser['mlh'][j] = oracle.melting_level_height_fast_column(tc, tdc, hc)
        sh = oracle.wind_shear_column(
            winds['surface_wind_u'][j], winds['surface_wind_v'][j],
            winds['wind_u'][j], winds['wind_v'][j],
            winds['wind_height_above_surface'][j])
        for k in ('shear_u', 'shear_v', 'shear_magnitude'):
            ser[k][j] = sh[k]
    # Per-column adversarial-feature records for the comparability filters:
    # nan_pmax bounds a NaN run from below by the valid level just beneath
    # it (0 when the column has no NaN levels).
    nan_pmax = np.zeros(N)
    for j in range(N):
        bad = np.isnan(p[j])
        if bad.any():
            # pressure of the valid level just below the run bounds it
            idx = np.flatnonzero(bad)
            below = idx.min() - 1
            nan_pmax[j] = p[j][below] if below >= 0 else np.inf
    dup_p = [p[j][np.flatnonzero(np.diff(p[j]) == 0)] for j in range(N)]
    return case, p, vec, ser, nan_pmax, dup_p


def _same_branch(a, b, tol=1.0):
    both_nan = np.isnan(a) & np.isnan(b)
    both_fin = ~np.isnan(a) & ~np.isnan(b)
    return both_nan | (both_fin & (np.abs(np.where(both_fin, a - b, 0.0))
                                   < tol))


_VEC_NAME = {'mu': 'mu', 'm100': 'mixed_100', 'm50': 'mixed_50'}


@pytest.mark.parametrize('name', ['mu', 'm100', 'm50'])
def test_parcel_variants_vs_serial(sweep, name):
    case, p, vec, ser, nan_pmax, dup_p = sweep
    if name == 'mu':
        same_parcel = np.abs(vec['_mu_parcel_pressure'] -
                             ser['mu_parcel_pressure']) < 1e-6
    else:
        same_parcel = np.ones((N,), bool)
    same = (same_parcel &
            _same_branch(vec[f'_{name}_lfc'], ser[f'{name}_lfc']) &
            _same_branch(vec[f'_{name}_el'], ser[f'{name}_el']))
    # Skip-vs-bridge filter: the vector is reference-faithful in SKIPPING
    # buoyancy areas across interior-NaN gaps (reference trapz :164-206);
    # the dropna oracle bridges them, so a NaN run is comparable only when
    # it sits entirely above the EL (outside both integration windows).
    el_eff = np.where(np.isnan(ser[f'{name}_el']),
                      np.array([np.nanmin(col) for col in p]),
                      ser[f'{name}_el'])
    same &= (nan_pmax == 0) | (nan_pmax < el_eff)
    # Knife-edge filters for duplicated levels:
    # (a) when the LFC/EL coincides (to ulps) with a duplicated data
    #     level — a zero-width crossing lands exactly on the level —
    #     window inclusion of the adjacent finite trapezoid flips on
    #     1-ulp rounding (the oracle's exp(log p) round-trip vs the
    #     vector's all-log comparison; the reference has the same exp
    #     round-trip);
    # (b) when the variant's LAUNCH pressure is itself duplicated: the
    #     vector matches the reference's pressure-threshold subsetting
    #     (``where(pressure <= parcel.pressure)``, reference :1551-1553)
    #     and keeps BOTH twins, while the oracle's index slicing keeps
    #     one — the spurious twin's environment discontinuity enters the
    #     integral on the vector/reference side only.
    for j in range(N):
        if len(dup_p[j]) and same[j]:
            launch = (ser['mu_parcel_pressure'][j] if name == 'mu'
                      else p[j][~np.isnan(p[j])][0])
            edges = [ser[f'{name}_lfc'][j], ser[f'{name}_el'][j], launch]
            if any(np.nanmin(np.abs(dup_p[j] - e)) < 1e-6
                   for e in edges if np.isfinite(e)):
                same[j] = False
    # The filters must keep a real fraction of the grid (no vacuous pass).
    assert same.mean() > 0.6, (
        f'{case}/{name}: only {same.mean():.0%} comparable')
    v = _VEC_NAME[name]
    for var, key, tol in ((f'{v}_cape', f'{name}_cape', 1e-4),
                          (f'{v}_cin', f'{name}_cin', 1e-4),
                          (f'{v}_lifted_index', f'{name}_li', 1e-5),
                          (f'{v}_dci', f'{name}_dci', 1e-5)):
        a, b = vec[var][same], ser[key][same]
        np.testing.assert_array_equal(
            np.isnan(a), np.isnan(b),
            err_msg=f'{case}: {var} NaN pattern')
        both = ~np.isnan(a)
        assert both.any(), f'{case}: {var} all-NaN on comparable columns'
        d = np.abs(a[both] - b[both])
        assert d.max() < tol, f'{case}: {var} max diff {d.max():.3e}'


def test_scalar_diagnostics_vs_serial(sweep):
    case, p, vec, ser, nan_pmax, _ = sweep
    # NaN-pattern equality is asserted on NaN-free columns; on columns with
    # interior-NaN runs the height diagnostics may legitimately diverge in
    # EXISTENCE: an isotherm crossing that falls inside a NaN gap is
    # invisible to the per-adjacent-pair crossing finder (vector AND
    # reference, find_intersections semantics) but found by the dropna
    # oracle, which bridges the gap.  Values must agree wherever both
    # sides are finite.
    no_nan = nan_pmax == 0
    for var, key, tol in (('lapse_rate_700_500', 'lapse', 1e-6),
                          ('temp_500', 't500', 1e-6),
                          ('freezing_level', 'flh', 1e-6),
                          ('melting_level', 'mlh', 1e-6),
                          ('shear_u', 'shear_u', 1e-8),
                          ('shear_v', 'shear_v', 1e-8),
                          ('shear_magnitude', 'shear_magnitude', 1e-8)):
        a, b = vec[var], ser[key]
        np.testing.assert_array_equal(
            np.isnan(a[no_nan]), np.isnan(b[no_nan]),
            err_msg=f'{case}: {var} NaN pattern')
        both = ~np.isnan(a) & ~np.isnan(b)
        if not var.startswith('shear'):
            # Level-interpolating diagnostics: a bridged gap can hand the
            # oracle a DIFFERENT (lower) isotherm crossing than the
            # vector's lowest visible one — value-comparable only on
            # NaN-free columns (shear's wind tracks are NaN-free).
            both = both & no_nan
        assert both.mean() > 0.25, f'{case}: {var} barely comparable'
        d = np.abs(a[both] - b[both])
        assert d.max() < tol, f'{case}: {var} max diff {d.max():.3e}'


def test_fused_matches_modular_on_adversarial_grids(sweep):
    """The fused and modular XLA pipelines share one set of column ops
    by construction; pin that the invariant holds on the ADVERSARIAL grid
    classes too — identical NaN/bool patterns and f64 agreement at
    machine precision."""
    case, p, vec, ser, _, _ = sweep
    # Rebuild the fixture's Dataset inputs for this case.
    seed = 400 + CASES.index(case)
    rng = np.random.default_rng(seed)
    _, t, td0 = (v[0].copy() for v in make_grid(ny=1, nx=N, L=L,
                                                seed=seed))
    pm, t, td0 = _mutate(case, p.copy(), t, td0, rng)
    q = np.asarray(jax.jit(thermo.specific_humidity_from_dewpoint)(
        jnp.asarray(p), jnp.asarray(td0)))
    h = 44330.0 * (1.0 - (np.where(np.isnan(p), 500.0, p)
                          / 1013.25) ** 0.19)
    h = np.where(np.isnan(p), np.nan, h)
    dat = {'pressure': jnp.asarray(p), 'temperature': jnp.asarray(t),
           'specific_humidity': jnp.asarray(q),
           'height_asl': jnp.asarray(h),
           'surface_wind_u': jnp.asarray(rng.normal(3, 2, N)),
           'surface_wind_v': jnp.asarray(rng.normal(0, 2, N)),
           'wind_u': jnp.asarray(rng.normal(8, 5, (N, L))),
           'wind_v': jnp.asarray(rng.normal(2, 5, (N, L))),
           'wind_height_above_surface': jnp.asarray(
               np.broadcast_to(np.linspace(0.0, 16000.0, L),
                               (N, L)).copy())}
    tables = adiabat.load_moist_adiabat_lookups()
    a = jax.jit(lambda d: pipeline.conv_properties(
        d, tables=tables, ignore_nans=True))(dat)
    b = jax.jit(lambda d: pipeline.conv_properties_fused(
        d, tables=tables, ignore_nans=True))(dat)
    a = {k: np.asarray(v) for k, v in a.items()}
    b = {k: np.asarray(v) for k, v in b.items()}
    assert set(a) == set(b)
    for k in sorted(a):
        va, vb = a[k], b[k]
        if va.dtype == bool:
            np.testing.assert_array_equal(va, vb, err_msg=f'{case}: {k}')
            continue
        np.testing.assert_array_equal(np.isnan(va), np.isnan(vb),
                                      err_msg=f'{case}: {k}')
        scale = max(1.0, float(np.nanmax(np.abs(va))) if
                    np.isfinite(va).any() else 1.0)
        np.testing.assert_allclose(np.nan_to_num(va), np.nan_to_num(vb),
                                   rtol=0, atol=1e-10 * scale,
                                   err_msg=f'{case}: {k}')


def test_sweep_grids_are_adversarial(sweep):
    """Each grid class really carries its adversarial feature."""
    case, p, vec, ser, nan_pmax, dup_p = sweep
    if case == 'dup_pressure':
        assert (np.diff(p, axis=-1) == 0).any(axis=-1).all()
    elif case == 'interior_nan':
        nan_cols = np.isnan(p).any(axis=-1)
        assert nan_cols.sum() >= N // 2
        # NaN runs are INTERIOR: first and last levels stay valid.
        assert not np.isnan(p[:, 0]).any() and not np.isnan(p[:, -1]).any()
    elif case == 'near_envelope':
        assert np.isfinite(vec['mu_cape']).any()
    elif case == 'deep_depression':
        # Deep depressions launch high LCLs; some columns must still
        # convect so the comparison is not vacuous.
        assert np.isfinite(vec['mu_cape']).any()
    elif case == 'combined':
        assert any(len(d) for d in dup_p)
        assert (nan_pmax > 0).any()
        assert np.isfinite(vec['mu_cape']).any()
