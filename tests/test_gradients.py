"""Differentiability: reverse-mode gradients through the full CAPE solve.

A capability the reference cannot offer at all (xarray+dask+scipy): the
whole pipeline is a pure jittable function, so dCAPE/d(inputs) comes from
jax.grad — useful for data assimilation, sensitivity analysis and ML
coupling.  NaN-sentinel masking is select-then-compute throughout, so
cotangents stay finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import adiabat, cape


@pytest.fixture(scope='module')
def tables():
    return adiabat.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def sounding():
    levels = jnp.array([959., 779.2, 751.3, 724.3, 700., 269.])
    temps = jnp.array([22.2, 14.6, 12., 9.4, 7., -38.]) + 273.15
    dews = jnp.array([19., -11.2, -10.8, -10.4, -10., -53.2]) + 273.15
    return levels, temps, dews


def test_grad_cape_wrt_surface_state(tables, sounding):
    levels, temps, dews = sounding

    def cape_of(t0, td0):
        res, _ = cape.surface_based_cape_cin(
            levels, temps.at[0].set(t0), dews.at[0].set(td0), tables=tables)
        return res['cape']

    g_t, g_td = jax.grad(cape_of, argnums=(0, 1))(temps[0], dews[0])
    eps = 1e-4
    fd_t = (cape_of(temps[0] + eps, dews[0]) -
            cape_of(temps[0] - eps, dews[0])) / (2 * eps)
    fd_td = (cape_of(temps[0], dews[0] + eps) -
             cape_of(temps[0], dews[0] - eps)) / (2 * eps)
    assert np.isfinite(float(g_t)) and np.isfinite(float(g_td))
    np.testing.assert_allclose(float(g_t), float(fd_t), rtol=1e-4)
    np.testing.assert_allclose(float(g_td), float(fd_td), rtol=1e-4)


def test_grad_batched_jacobian(tables, sounding):
    levels, temps, dews = sounding
    B = 4
    lv = jnp.broadcast_to(levels, (B, 6))
    tp = jnp.broadcast_to(temps, (B, 6)) + jnp.arange(B)[:, None] * 0.5
    dw = jnp.broadcast_to(dews, (B, 6))

    def total_cape(tp):
        res, _ = cape.surface_based_cape_cin(lv, tp, dw, tables=tables)
        return jnp.sum(res['cape'])

    g = jax.grad(total_cape)(tp)
    assert g.shape == tp.shape
    assert np.isfinite(np.asarray(g)).all()
    # Surface perturbations must matter most.
    assert np.all(np.abs(np.asarray(g)[:, 0]) > 0)


def test_grad_through_parcel_variants(tables, sounding):
    # Gradients survive the NaN-padded subset columns of the MU path and
    # the mixed-layer prep.
    from xarray_parcel_tpu import parcels
    levels, temps, dews = sounding
    eps = 1e-4
    for fn in (parcels.most_unstable_cape_cin, parcels.mixed_layer_cape_cin):
        def cape_of(t1, fn=fn):
            res, _, _ = fn(levels, temps.at[1].set(t1), dews, tables=tables)
            return res['cape']
        g = jax.grad(cape_of)(temps[1])
        fd = (cape_of(temps[1] + eps) - cape_of(temps[1] - eps)) / (2 * eps)
        assert np.isfinite(float(g))
        np.testing.assert_allclose(float(g), float(fd), rtol=1e-3)


def test_grad_through_fused_kernel(tables, sounding):
    # The fused production solve is differentiable end to end: plain jnp
    # under jit, so reverse mode needs no custom rule.
    from xarray_parcel_tpu import fused
    levels, temps, dews = sounding
    lv, tp, dw = levels[None], temps[None], dews[None]

    def cape_of(t0):
        res, _ = fused.fused_surface_cape_cin(
            lv, tp.at[0, 0].set(t0), dw, tables=tables)
        return res['cape'][0]

    g = jax.grad(cape_of)(temps[0])
    eps = 1e-4
    fd = (cape_of(temps[0] + eps) - cape_of(temps[0] - eps)) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-4)


def test_grad_through_full_pipeline(tables, sounding):
    # dOutput/dInput through the entire ~20-variable pipeline (every solve,
    # diagnostic and the NaN-masking) stays finite and matches finite
    # differences — the reference (xarray+dask+scipy) cannot do this at all.
    from xarray_parcel_tpu import pipeline, thermo
    levels, temps, dews = sounding
    q = thermo.specific_humidity_from_dewpoint(levels, dews)
    h = 44330.0 * (1.0 - (levels / 1013.25) ** 0.19)
    base = {
        'pressure': levels[None], 'temperature': temps[None],
        'specific_humidity': q[None], 'height_asl': h[None],
        'surface_wind_u': jnp.array([3.0]),
        'surface_wind_v': jnp.array([0.0]),
        'wind_u': jnp.full((1, levels.shape[0]), 8.0),
        'wind_v': jnp.full((1, levels.shape[0]), 2.0),
        'wind_height_above_surface': (h - h[0])[None],
    }

    def mu_cape_of(t1):
        dat = dict(base)
        dat['temperature'] = temps.at[1].set(t1)[None]
        out = pipeline.conv_properties(dat, tables=tables)
        return out['mu_cape'][0]

    g = jax.grad(mu_cape_of)(temps[1])
    eps = 1e-4
    fd = (mu_cape_of(temps[1] + eps) - mu_cape_of(temps[1] - eps)) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-3)


def test_lcl_nan_parcel_zero_gradient():
    # The fixed point iterates on safe dummies: a NaN parcel's cotangent is
    # exactly zero, never 0 * NaN (the where-NaN trap through the power
    # backward rule).
    import jax
    from xarray_parcel_tpu.lcl import lcl

    def total(t):
        out = lcl(jnp.full_like(t, 1000.0), t, t - 5.0)
        return jnp.nansum(jnp.where(jnp.isnan(out['lcl_pressure']), 0.0,
                                    out['lcl_pressure']))

    g = np.asarray(jax.grad(total)(jnp.array([300.0, jnp.nan, 295.0])))
    assert np.isfinite(g[[0, 2]]).all() and g[1] == 0.0, g
