"""Moist-adiabat engine tests: RK4 integrator, table build, table consumer.

The integrator is validated against scipy.integrate.solve_ivp (an oracle the
reference never had — it trusted MetPy); the tables are validated against the
integrator on the domain the reference quotes its 0.037 K figure for
(reference: parcel_functions_demo.ipynb cell 20), plus golden moist-lapse
values at the reference's loosened table tolerance
(reference: modules/unit_tests.py:106-112).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_array_almost_equal
from scipy.integrate import solve_ivp

from xarray_parcel_tpu import adiabat
from xarray_parcel_tpu.thermo import moist_lapse_rate


@pytest.fixture(scope='session')
def tables():
    return adiabat.load_moist_adiabat_lookups()


def test_rk4_matches_scipy():
    def rhs(p, t):
        return np.asarray(moist_lapse_rate(p, t[0]))[None]

    for t0, p0, p1 in [(293.0, 1000.0, 300.0), (260.0, 900.0, 150.0),
                       (310.0, 1050.0, 200.0)]:
        ours = float(adiabat.integrate_between(
            jnp.asarray(t0), jnp.log(jnp.asarray(p0)),
            jnp.log(jnp.asarray(p1)), n_substeps=64))
        ref = solve_ivp(rhs, (p0, p1), [t0], rtol=1e-11, atol=1e-11).y[0, -1]
        assert abs(ours - ref) < 2e-6, (t0, p0, p1, ours, ref)


def test_generated_curves_match_scipy(tables):
    # Spot-check full curves against scipy at a few start temperatures.
    def rhs(p, t):
        return np.asarray(moist_lapse_rate(p, t[0]))[None]

    pgrid = np.asarray(adiabat.pressure_grid())
    starts = np.asarray(adiabat.curve_start_temperatures())
    for i in [0, 7151, 14299]:
        sol = solve_ivp(rhs, (1100.0, 2.5), [float(starts[i])], rtol=1e-11,
                        atol=1e-11, dense_output=True)
        ref = sol.sol(pgrid)[0]
        got = np.asarray(tables.curves[i])
        assert np.max(np.abs(got - ref)) < 5e-5, i


def test_lookup_envelope_and_monotonicity(tables):
    lk = np.asarray(tables.lookup)
    # Fractional index increases with temperature where defined.
    d = np.diff(lk, axis=1)
    assert np.nanmin(d) >= 0
    # Cells far outside the envelope are NaN (e.g. 315 K at 150 hPa).
    ip = int(round((adiabat.P_TOP - 150.0) / adiabat.P_STEP))
    it = int(round((315.0 - adiabat.T_MIN) / adiabat.T_STEP))
    assert np.isnan(lk[ip, it])


def test_moist_lapse_table_golden(tables):
    # Reference parity: table-backed moist lapse passes the golden values at
    # the reference's loosened 2-decimal tolerance in nearest mode
    # (reference: modules/unit_tests.py:106-112, run_moist_lapse_tests_looser)
    # and at full tolerance in bilinear+blend mode.
    levels = jnp.array([1000., 800., 600., 500., 400.])
    truth = [293, 284.64, 272.81, 264.42, 252.91]
    nearest = adiabat.moist_lapse(levels, 293.0, tables=tables,
                                  bilinear=False, curve_blend=False)
    assert_array_almost_equal(np.asarray(nearest), truth, 1)
    assert np.max(np.abs(np.asarray(nearest) - np.asarray(truth))) < 0.016
    blended = adiabat.moist_lapse(levels, 293.0, tables=tables)
    assert_array_almost_equal(np.asarray(blended), truth, 2)

    ref_pres = adiabat.moist_lapse(jnp.array([1050., 800., 600., 500., 400.]),
                                   293.0, 1000.0, tables=tables)
    assert_array_almost_equal(np.asarray(ref_pres),
                              [294.76, 284.64, 272.81, 264.42, 252.91], 2)

    uniform = adiabat.moist_lapse(jnp.array([900., 900., 900.]), 293.15,
                                  tables=tables)
    assert_array_almost_equal(np.asarray(uniform), [293.15] * 3, 2)


def test_table_vs_oracle_accuracy(tables):
    # Reference quotes 0.037 K max error for its nearest/nearest tables on
    # 1000-hPa parcels, 250-313 K (demo nb cell 20).  The bilinear+blend
    # consumer must be far better; nearest mode comparable.
    ptemp = jnp.array(np.linspace(250.0, 313.0, 127))
    lev = jnp.array(np.broadcast_to(np.round(np.arange(1000, 99, -9.0), 1),
                                    (127, 101)))
    oracle = np.asarray(adiabat.moist_lapse_integrate(lev, ptemp, 1000.0))
    blended = np.asarray(adiabat.moist_lapse(lev, ptemp, 1000.0,
                                             tables=tables))
    nearest = np.asarray(adiabat.moist_lapse(lev, ptemp, 1000.0,
                                             tables=tables, bilinear=False,
                                             curve_blend=False))
    assert np.nanmax(np.abs(blended - oracle)) < 1e-3
    assert np.nanmax(np.abs(nearest - oracle)) < 0.1


def test_moist_lapse_nan_semantics(tables):
    levels = jnp.array([1000., 800., jnp.nan, 400.])
    out = np.asarray(adiabat.moist_lapse(levels, 293.0, tables=tables))
    assert np.isnan(out[2]) and not np.isnan(out[[0, 1, 3]]).any()
    # NaN parcel -> all NaN.
    out2 = np.asarray(adiabat.moist_lapse(levels, jnp.nan, tables=tables))
    assert np.all(np.isnan(out2))
    # Out-of-range pressures -> NaN (no extrapolation).
    out3 = np.asarray(adiabat.moist_lapse(jnp.array([1150.0, 1.0]), 293.0,
                                          1000.0, tables=tables))
    assert np.all(np.isnan(out3))
    # Out-of-envelope parcel -> NaN.
    out4 = np.asarray(adiabat.moist_lapse(jnp.array([500.0]), 315.0, 150.0,
                                          tables=tables))
    assert np.all(np.isnan(out4))


def test_moist_lapse_pointwise(tables):
    # Pointwise mode: one target pressure per parcel (wet-bulb pattern).
    p = jnp.array([1000.0, 900.0, 850.0])
    t = jnp.array([293.0, 290.0, 288.0])
    pw = adiabat.moist_lapse(p - 50.0, t, p, tables=tables)
    # Profile mode evaluates spectrally, pointwise mode gathers from the
    # dense curves — equal to table accuracy, not bitwise.
    full = adiabat.moist_lapse((p - 50.0)[:, None], t, p, tables=tables)
    assert_array_almost_equal(np.asarray(pw), np.asarray(full)[:, 0], 3)


def test_cape_table_vs_oracle(tables):
    # The bench path (table backend) agrees with the oracle on CAPE/CIN.
    from xarray_parcel_tpu import api
    levels = jnp.array([959., 779.2, 751.3, 724.3, 700., 269.])
    temps = jnp.array([22.2, 14.6, 12., 9.4, 7., -38.]) + 273.15
    dews = jnp.array([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15
    res_t, _ = api.surface_based_cape_cin(levels, temps, dews, tables=tables)
    res_o, _ = api.surface_based_cape_cin(
        levels, temps, dews, moist_lapse=adiabat.moist_lapse_integrate)
    assert abs(float(res_t['cape'][()]) - float(res_o['cape'][()])) < 0.1
    assert abs(float(res_t['cin'][()]) - float(res_o['cin'][()])) < 0.1


def test_moist_lapse_pointwise_default_parcel_pressure(tables):
    # Pointwise mode with no parcel_pressure: each point is its own start,
    # so the result is the input temperature (zero lift).
    p = jnp.full((3, 4), 900.0)
    t = jnp.full((3, 4), 285.0)
    out = adiabat.moist_lapse(p, t, tables=tables)
    assert out.shape == (3, 4)
    assert_array_almost_equal(np.asarray(out), np.asarray(t), 3)


def test_spectral_segment_continuity(tables):
    # The piecewise fit is three independent Chebyshev series; adjacent
    # segments may disagree at a shared boundary only by ~the fit error
    # (6.7e-5 K over the envelope, spectral_piecewise_study.py), never by
    # a visible jump that could seed a spurious crossing in the solver.
    eps = 1e-4
    rows = tables.coeffs[::997]                       # sample of curves
    for split in adiabat.SEG_SPLITS:
        lo = adiabat._eval_spectral(rows, jnp.asarray([split - eps]))
        hi = adiabat._eval_spectral(rows, jnp.asarray([split + eps]))
        jump = np.abs(np.asarray(lo) - np.asarray(hi))
        assert np.nanmax(jump) < 3e-4, (split, float(np.nanmax(jump)))


def test_spectral_matches_exact_ode(tables):
    # End-to-end accuracy of the piecewise representation against the
    # backward-RK4 oracle at random interior (curve, pressure) pairs.
    rng = np.random.default_rng(11)
    idx = rng.integers(0, tables.coeffs.shape[0], 16)
    ps = rng.uniform(adiabat.P_BOT + 1.0, adiabat.P_TOP - 1.0, 16)
    t0 = adiabat.curve_start_temperatures(tables.curves.dtype)
    lnp_top = float(np.log(adiabat.P_TOP))
    for i, p in zip(idx, ps):
        exact = float(adiabat.integrate_between(
            t0[i], jnp.asarray(lnp_top), jnp.log(jnp.asarray(p)),
            n_substeps=512))
        spec = float(adiabat._eval_spectral(tables.coeffs[i],
                                            jnp.asarray([p]))[0])
        assert abs(spec - exact) < 5e-4, (int(i), float(p), spec, exact)


def test_stale_spectral_cache_rebuilds(tmp_path, monkeypatch):
    # A cache written under the old global K=48 representation keeps its
    # curves/lookup but must rebuild the coefficients on load.
    path = str(tmp_path / 'stale.npz')
    np.savez_compressed(path,
                        curves=np.ones((5, 7), np.float32),
                        lookup=np.ones((7, 3), np.float32),
                        coeffs=np.zeros((5, 48), np.float32))
    calls = []

    def fake_build(dtype=None, **kw):
        calls.append(dtype)
        return jnp.zeros((5, adiabat.N_COEF),
                         dtype or jnp.float32)

    monkeypatch.setattr(adiabat, 'build_spectral', fake_build)
    loaded = adiabat.AdiabatTables.load(path)
    assert calls, 'stale 48-wide coefficients were not rebuilt'
    assert loaded.coeffs.shape == (5, adiabat.N_COEF)
    # A current-shape cache loads without rebuilding.
    path2 = str(tmp_path / 'fresh.npz')
    np.savez_compressed(path2,
                        curves=np.ones((5, 7), np.float32),
                        lookup=np.ones((7, 3), np.float32),
                        coeffs=np.zeros((5, adiabat.N_COEF), np.float32))
    calls.clear()
    loaded2 = adiabat.AdiabatTables.load(path2)
    assert not calls and loaded2.coeffs.shape == (5, adiabat.N_COEF)


def test_stale_wide_cache_narrow_request_persists_default(tmp_path,
                                                          monkeypatch):
    # A stale (48-wide) f64 cache serving an f32 request must NOT be
    # overwritten with narrowed tables, but the narrowed rebuild must be
    # persisted to the dtype-keyed default path — otherwise every f32
    # process rebuilds the spectra forever.
    import os
    monkeypatch.setattr(adiabat, '_CACHE_DIR', str(tmp_path))
    monkeypatch.setattr(adiabat, '_DEFAULT_TABLES', None)
    monkeypatch.setattr(adiabat, '_DEFAULT_SOURCE', None)
    calls = []

    def fake_build(dtype=None, **kw):
        calls.append(dtype)
        return jnp.zeros((5, adiabat.N_COEF), dtype or jnp.float32)

    monkeypatch.setattr(adiabat, 'build_spectral', fake_build)
    wide = str(tmp_path / 'adiabat_tables_f64.npz')
    np.savez_compressed(wide, curves=np.ones((5, 7), np.float64),
                        lookup=np.ones((7, 3), np.float32),
                        coeffs=np.zeros((5, 48), np.float64))

    tab = adiabat.load_moist_adiabat_lookups(dtype=jnp.float32)
    assert calls and tab.curves.dtype == jnp.float32
    f32path = str(tmp_path / 'adiabat_tables_f32.npz')
    assert os.path.exists(f32path), 'narrowed rebuild not persisted'
    with np.load(f32path) as f:
        assert f['coeffs'].shape[-1] == adiabat.N_COEF
        assert f['curves'].dtype == np.float32
    with np.load(wide) as f:
        assert f['coeffs'].shape[-1] == 48, 'wide cache was overwritten'

    # A fresh process (reset globals) now loads the f32 cache directly.
    monkeypatch.setattr(adiabat, '_DEFAULT_TABLES', None)
    monkeypatch.setattr(adiabat, '_DEFAULT_SOURCE', None)
    calls.clear()
    adiabat.load_moist_adiabat_lookups(dtype=jnp.float32)
    assert not calls, 'second load rebuilt despite the persisted cache'


def test_legacy_coeff_width_warns():
    import warnings as _w
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter('always')
        adiabat.AdiabatTables(np.ones((5, 7), np.float32),
                              np.ones((7, 3), np.float32),
                              np.zeros((5, 48), np.float32))
    assert any('piecewise layout' in str(r.message) for r in rec)


def test_moist_lapse_shared_pressure_batched_parcels(tables):
    # A shared 1-D level vector with batched parcels is a PROFILE call
    # (the cape.cape_cin contract), never pointwise — including the
    # ambiguous batch == levels case when passed explicitly.
    p = jnp.linspace(900.0, 400.0, 8)
    t0 = jnp.full((3,), 293.15)
    p0 = jnp.full((3,), 1000.0)
    out = adiabat.moist_lapse(p, t0, p0, tables=tables)
    assert out.shape == (3, 8)
    out_sq = adiabat.moist_lapse(p, jnp.full((8,), 293.15),
                                 jnp.full((8,), 1000.0), tables=tables,
                                 pointwise=False)
    assert out_sq.shape == (8, 8)
    np.testing.assert_allclose(np.asarray(out_sq[0]), np.asarray(out[0]),
                               rtol=1e-6)
    oracle = adiabat.moist_lapse_integrate(p, t0, p0)
    assert oracle.shape == (3, 8)
    np.testing.assert_allclose(np.asarray(out), np.asarray(oracle),
                               atol=5e-4)


def test_curve_index_envelope_matches_table_consumer(tables):
    # A parcel within half a temperature-axis cell of the curve family's
    # envelope must be finite in EVERY index mode (the integrate mode used
    # a half-INDEX tolerance, flipping such parcels to NaN).
    for mode in ('integrate', 'bilinear', 'nearest'):
        v = adiabat.moist_lapse(jnp.asarray([1000.0]), jnp.asarray(315.997),
                                jnp.asarray(1100.0), tables=tables,
                                index_mode=mode, pointwise=False)
        assert np.isfinite(float(v[0])), mode


def test_spectralless_tables_save_load_and_fused_error(tmp_path):
    import os
    import pytest
    from xarray_parcel_tpu import fused
    small = adiabat.AdiabatTables(jnp.ones((5, 7), jnp.float32),
                                  jnp.ones((7, 3), jnp.float32))
    path = str(tmp_path / 'no_coeffs.npz')
    small.save(path)                      # must not crash on coeffs=None
    with np.load(path) as f:
        assert 'coeffs' not in f.files
    with pytest.raises(ValueError, match='spectral'):
        fused.fused_cape_cin(jnp.ones((2, 4)) * 900.0,
                             jnp.ones((2, 4)) * 280.0,
                             jnp.ones((2, 4)) * 275.0, tables=small)
