"""Regression tests for the round-8 core-numerics review findings.

Each test pins a specific reviewed-and-fixed behavior:

1. ``lfc_el(intersections_in_log=True)`` without a precomputed crossing set
   must build the set in log space (it used to build linear x and compare
   it against log-pressure windows — silent unit crossing).
2. The first-level parcel==environment rule is ulp-tolerant: the fused path
   computes the two tracks in different fusions (per-parcel pre-pass vs
   column program), so exact float equality could silently disable the
   ignore-first-level rule.
3. ``mixed_parcel`` anchors at the first VALID level, not slot 0: a NaN
   bottom slot used to yield an all-NaN parcel and (under ``grow=True``)
   flood the whole column.
4. ``ops.compact_left`` promotes non-float fields to float32 so the NaN
   fill is representable (an int 0-pad was indistinguishable from data).
5. ``adiabat._stored_dtype`` reads the .npy header only and returns None on
   unreadable files.
"""

import os

import jax.numpy as jnp
import numpy as np
from numpy.testing import assert_allclose, assert_almost_equal

from xarray_parcel_tpu import adiabat, api, ops, parcels
from xarray_parcel_tpu.cape import lfc_el

ORACLE = dict(moist_lapse=adiabat.moist_lapse_integrate)

LEVELS = np.array([959., 779.2, 751.3, 724.3, 700., 269.])
TEMPS = np.array([22.2, 14.6, 12., 9.4, 7., -49.]) + 273.15
DEWS = np.array([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15


def _profile():
    levels, temps, dews = map(jnp.asarray, (LEVELS, TEMPS, DEWS))
    return api.parcel_profile_with_lcl(
        pressure=levels, temperature=temps, dewpoint=dews,
        parcel_pressure=levels[0], parcel_temperature=temps[0],
        parcel_dewpoint=dews[0], lcl_interp='linear', **ORACLE)


def test_lfc_el_self_built_log_intersections():
    """intersections_in_log=True with NO precomputed set must agree with the
    linear-space default (same crossings, log-monotone comparisons)."""
    prof = _profile()
    args = (prof['pressure'], prof['temperature'],
            prof['environment_temperature'], prof['lcl_pressure'],
            prof['lcl_temperature'])
    lin = lfc_el(*args)
    log = lfc_el(*args, intersections_in_log=True)
    # The log variant threads private log-space keys to cape_cin_base
    # (np.exp vs jnp exp may differ by an ulp).
    assert_allclose(float(np.exp(log['_lfc_log_pressure'])),
                    float(np.asarray(log['lfc_pressure'])), rtol=1e-14)
    for k in ('lfc_pressure', 'lfc_temperature', 'el_pressure',
              'el_temperature'):
        assert_allclose(np.asarray(log[k]), np.asarray(lin[k]),
                        rtol=1e-12, err_msg=k)
    # Sanity against the reference truth (test_lfc_basic).
    assert_almost_equal(float(np.asarray(lin['lfc_pressure'])), 727.371, 2)


def test_same_first_level_rule_is_ulp_tolerant():
    """A first-level parcel track differing from the environment by 1-2 ulps
    (the fused path's cross-compiler reality) must still trigger the
    ignore-first-level rule — same LFC as the exactly-equal track."""
    prof = _profile()
    pt = np.asarray(prof['temperature'], np.float32)
    args_exact = (jnp.asarray(prof['pressure'], jnp.float32),
                  jnp.asarray(pt),
                  jnp.asarray(prof['environment_temperature'], jnp.float32),
                  jnp.asarray(prof['lcl_pressure'], jnp.float32),
                  jnp.asarray(prof['lcl_temperature'], jnp.float32))
    exact = lfc_el(*args_exact)
    pt_ulp = pt.copy()
    pt_ulp[..., 0] = np.nextafter(np.nextafter(pt_ulp[..., 0],
                                               np.float32(np.inf)),
                                  np.float32(np.inf))
    wobbled = lfc_el(args_exact[0], jnp.asarray(pt_ulp), *args_exact[2:])
    assert_allclose(np.asarray(wobbled['lfc_pressure']),
                    np.asarray(exact['lfc_pressure']), rtol=1e-5)
    # But a PHYSICALLY different first level (mixed-parcel scale, ~0.1 K)
    # must NOT be treated as equal.
    pt_diff = pt.copy()
    pt_diff[..., 0] += 0.1
    tol = 8 * np.finfo(np.float32).eps * np.abs(pt_diff[..., 0])
    assert np.all(np.abs(pt_diff[..., 0] - pt[..., 0]) > tol)


def test_mixed_parcel_nan_bottom_slot():
    """A NaN bottom slot (leading-NaN prefix) must not destroy the parcel:
    both mix_layer modes agree with each other and with the compacted
    column's result."""
    p = np.concatenate([[np.nan], LEVELS])
    t = np.concatenate([[np.nan], TEMPS])
    td = np.concatenate([[np.nan], DEWS])

    mp_pad = parcels.mixed_parcel(jnp.asarray(p), jnp.asarray(t),
                                  jnp.asarray(td))
    mp_ref = parcels.mixed_parcel(jnp.asarray(LEVELS), jnp.asarray(TEMPS),
                                  jnp.asarray(DEWS))
    for k in mp_ref:
        assert np.isfinite(np.asarray(mp_pad[k])), k
        assert_allclose(np.asarray(mp_pad[k]), np.asarray(mp_ref[k]),
                        rtol=1e-12, err_msg=k)

    grown, _ = parcels.mix_layer(jnp.asarray(p), jnp.asarray(t),
                                 jnp.asarray(td), grow=True)
    slotted, _ = parcels.mix_layer(jnp.asarray(p), jnp.asarray(t),
                                   jnp.asarray(td), grow=False)
    # Same physical profile: identical valid (pressure, temperature) pairs.
    for fields in (grown, slotted):
        pv = np.asarray(fields['pressure'])
        assert np.isfinite(pv).sum() > 0
    gp, gt = (np.asarray(grown[k]) for k in ('pressure', 'temperature'))
    sp, st = (np.asarray(slotted[k]) for k in ('pressure', 'temperature'))
    assert_allclose(gp[np.isfinite(gp)], sp[np.isfinite(sp)], rtol=1e-12)
    assert_allclose(gt[np.isfinite(gp)], st[np.isfinite(sp)], rtol=1e-12)


def test_mixed_layer_cape_cin_nan_bottom_matches_compacted():
    """End-to-end: mixed-layer CAPE/CIN on a leading-NaN-padded column
    equals the same column compacted (the framework's first-valid-index
    contract)."""
    p = np.concatenate([[np.nan], LEVELS])
    t = np.concatenate([[np.nan], TEMPS])
    td = np.concatenate([[np.nan], DEWS])
    res_pad, _, _ = parcels.mixed_layer_cape_cin(
        jnp.asarray(p), jnp.asarray(t), jnp.asarray(td), **ORACLE)
    res_ref, _, _ = parcels.mixed_layer_cape_cin(
        jnp.asarray(LEVELS), jnp.asarray(TEMPS), jnp.asarray(DEWS), **ORACLE)
    assert_allclose(float(res_pad['cape']), float(res_ref['cape']),
                    rtol=1e-10, atol=1e-8)
    assert_allclose(float(res_pad['cin']), float(res_ref['cin']),
                    rtol=1e-10, atol=1e-8)


def test_compact_left_promotes_int_and_bool():
    out = ops.compact_left(
        {'pressure': jnp.asarray([[np.nan, 1000.0, 900.0]]),
         'flag': jnp.asarray([[7, 8, 9]], jnp.int32),
         'ok': jnp.asarray([[True, False, True]])}, 'pressure')
    assert out['flag'].dtype == jnp.float32
    assert out['ok'].dtype == jnp.float32
    assert_allclose(np.asarray(out['flag'])[0, :2], [8.0, 9.0])
    assert np.isnan(np.asarray(out['flag'])[0, 2])
    assert np.isnan(np.asarray(out['ok'])[0, 2])


def test_stored_dtype_header_only(tmp_path):
    path = os.path.join(tmp_path, 'tables.npz')
    np.savez_compressed(path, curves=np.zeros((3, 4), np.float32),
                        lookup=np.zeros((2, 2), np.float32),
                        coeffs=np.zeros((1,), np.float32))
    assert adiabat._stored_dtype(path) == np.float32
    bad = os.path.join(tmp_path, 'bad.npz')
    with open(bad, 'wb') as fh:
        fh.write(b'not a zip')
    assert adiabat._stored_dtype(bad) is None
    assert adiabat._stored_dtype(os.path.join(tmp_path, 'nope.npz')) is None
