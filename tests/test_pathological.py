"""Degenerate physical soundings through the FULL pipeline, both paths.

The NaN-fuzz suite (test_nan_fuzz.py) stresses missing-data *patterns* on
the surface solve; this file stresses physically degenerate but valid
*values* end to end through ``conv_properties`` and
``conv_properties_fused`` (reference entry point
modules/parcel_functions.py:1951):

  - saturated columns (dewpoint == temperature: LCL at the parcel level)
  - isothermal columns
  - strong inversions (no LFC anywhere -> CAPE 0 everywhere)
  - very cold surface parcels near the adiabat-table lower edge (173 K
    start-temperature bound, reference parcel_functions.py:447-451)
  - columns with only a handful of valid levels (deep NaN top-padding)
  - superadiabatic surface layers
  - near-duplicate pressure runs (strictly decreasing by ~1e-3 hPa, the
    duplicate-aware interpolation regime of parcel_functions.py:1758)

Contracts checked: the fused path and the modular XLA path agree
bit-for-bit on NaN patterns and to fp tolerance on values (the two paths
share ``fused._column_program`` — any divergence is a semantics fork);
CAPE is non-negative and CIN non-positive under the default
pos_cape_neg_cin convention; storm proxies evaluate to booleans without
raising.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import adiabat, pipeline

L = 40


@pytest.fixture(scope='module')
def tables():
    return adiabat.load_moist_adiabat_lookups()


def _base_profile():
    """A plain decreasing-pressure, ISA-ish column."""
    p = np.linspace(1005.0, 180.0, L)
    t = 300.0 - 70.0 * (1.0 - (p / 1005.0) ** 0.3)
    td = t - 6.0
    return p, t, td


def _pathological_grid():
    cols = []

    # 0: saturated from the surface up (LCL == parcel level).
    p, t, td = _base_profile()
    cols.append((p, t, t.copy()))

    # 1: saturated only at the surface level.
    p, t, td = _base_profile()
    td = td.copy()
    td[0] = t[0]
    cols.append((p, t, td))

    # 2: isothermal column.
    p, _, _ = _base_profile()
    t = np.full(L, 263.0)
    cols.append((p, t, t - 8.0))

    # 3: strong inversion — temperature INCREASES with height, so the
    # lifted parcel is colder than the environment everywhere (no LFC).
    p, _, _ = _base_profile()
    t = 250.0 + 40.0 * (1.0 - p / 1005.0)
    cols.append((p, t, t - 10.0))

    # 4: very cold, very dry surface parcel near the table's 173 K
    # start-temperature edge once lifted dry-adiabatically.
    p, _, _ = _base_profile()
    t = 218.0 - 25.0 * (1.0 - (p / 1005.0) ** 0.3)
    cols.append((p, t, t - 3.0))

    # 5: only the lowest 4 levels valid, the rest NaN (deep top padding).
    p, t, td = _base_profile()
    p, t, td = p.copy(), t.copy(), td.copy()
    p[4:] = t[4:] = td[4:] = np.nan
    cols.append((p, t, td))

    # 6: superadiabatic surface layer (common in heated boundary layers).
    p, t, td = _base_profile()
    t = t.copy()
    t[0] += 12.0
    cols.append((p, t, td))

    # 7: near-duplicate pressures — an 8-level run spaced 1e-3 hPa apart
    # around 700 hPa (strictly decreasing, as valid_data requires).
    p, t, td = _base_profile()
    p = p.copy()
    k = np.argmin(np.abs(p - 700.0))
    p[k:k + 8] = p[k] - 1e-3 * np.arange(8)
    p = -np.sort(-p)
    cols.append((p, t, td))

    # 8: extremely moist tropical column (high CAPE regime).  The
    # environment follows ~t0*(p/p0)^0.19 (~6.5 K/km), well steeper than
    # a moist adiabat from a 304/303 K surface parcel.
    p, _, _ = _base_profile()
    t = 304.0 * (p / 1005.0) ** 0.19
    cols.append((p, t, t - 1.0))

    p = np.stack([c[0] for c in cols])
    t = np.stack([c[1] for c in cols])
    td = np.stack([c[2] for c in cols])
    return p, t, td


def _as_dataset(p, t, td):
    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = 0.6219569100577033 * e / (p - e)
    q = w / (1.0 + w)
    h = 44330.0 * (1.0 - (np.where(np.isnan(p), 500.0, p) / 1013.25) ** 0.19)
    B = p.shape[0]
    rng = np.random.default_rng(7)
    return {k: jnp.asarray(v) for k, v in {
        'pressure': p, 'temperature': t, 'specific_humidity': q,
        'height_asl': h,
        'surface_wind_u': rng.normal(3, 2, (B,)),
        'surface_wind_v': rng.normal(0, 2, (B,)),
        'wind_u': rng.normal(8, 5, (B, L)),
        'wind_v': rng.normal(2, 5, (B, L)),
        'wind_height_above_surface': h - h[..., :1],
    }.items()}


@pytest.fixture(scope='module')
def outputs(tables):
    dat = _as_dataset(*_pathological_grid())
    ref = pipeline.conv_properties(dat, tables=tables)
    got = pipeline.conv_properties_fused(dat, tables=tables)
    return ref, got


def test_fused_matches_modular_on_pathological_grid(outputs):
    ref, got = outputs
    assert set(got) == set(ref)
    for k in sorted(ref):
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=5e-6, rtol=1e-9, err_msg=k)


def test_cape_cin_sign_convention(outputs):
    ref, _ = outputs
    for k in ('mu_cape', 'mixed_100_cape', 'mixed_50_cape'):
        v = np.asarray(ref[k])
        assert np.all(v[np.isfinite(v)] >= 0.0), k
    for k in ('mu_cin', 'mixed_100_cin', 'mixed_50_cin'):
        v = np.asarray(ref[k])
        assert np.all(v[np.isfinite(v)] <= 0.0), k


def test_inversion_column_has_zero_cape(outputs):
    ref, _ = outputs
    # Column 3: parcel colder than environment everywhere -> no LFC,
    # CAPE exactly 0 (reference lfc_el LCL-substitution rules cannot fire
    # because buoyancy never turns positive).
    assert float(ref['mu_cape'][3]) == 0.0
    assert float(ref['mixed_100_cape'][3]) == 0.0


def test_tropical_column_has_large_cape(outputs):
    ref, _ = outputs
    # Column 8: near-saturated warm tropical sounding -> substantial CAPE.
    assert float(ref['mu_cape'][8]) > 500.0


def test_sparse_column_is_finite_or_nan_not_garbage(outputs):
    ref, _ = outputs
    # Column 5 has 4 valid levels: every output is either finite or NaN
    # (never inf), and the valid-data mask semantics keep it in-range.
    for k, v in ref.items():
        arr = np.asarray(v[5])
        if arr.dtype == bool:
            continue
        assert not np.any(np.isinf(arr)), k


def test_storm_proxies_on_pathological_grid(outputs):
    ref, _ = outputs
    prox = pipeline.storm_proxies(ref)
    assert prox
    for k, v in prox.items():
        arr = np.asarray(v)
        if k == 'ship':
            # SHIP is the one float output (reference keeps it alongside
            # the boolean proxies, parcel_functions.py:2398-2401).
            assert arr.dtype != bool
            continue
        assert arr.dtype == bool, k
        # The inversion column can never fire a CAPE-gated proxy.
        if k != 'proxy_Kunz2007' and k != 'proxy_Mohr2013':
            assert not arr[3], k
