"""Fused-pipeline variant vs the modular pipeline."""

import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import adiabat, pipeline


@pytest.fixture(scope='module')
def tables():
    return adiabat.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def dat():
    rng = np.random.default_rng(11)
    B, L = 48, 44
    p = np.linspace(1007.0, 160.0, L)
    p = np.broadcast_to(p, (B, L)) + rng.normal(0, 0.3, (B, L))
    p = -np.sort(-p, axis=-1)
    t = 301.0 - 75.0 * (1.0 - (p / 1007.0) ** 0.3) + rng.normal(0, 2, (B, L))
    td = t - (np.abs(rng.normal(2, 2, (B, L))) + 0.3 +
              14.0 * (1.0 - p / 1007.0) ** 2)
    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = 0.6219569100577033 * e / (p - e)
    q = w / (1.0 + w)
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    t[0, 3] = np.nan              # one poisoned column
    return {k: jnp.asarray(v) for k, v in {
        'pressure': p, 'temperature': t, 'specific_humidity': q,
        'height_asl': h,
        'surface_wind_u': rng.normal(3, 2, (B,)),
        'surface_wind_v': rng.normal(0, 2, (B,)),
        'wind_u': rng.normal(8, 5, (B, L)),
        'wind_v': rng.normal(2, 5, (B, L)),
        'wind_height_above_surface': h - h[..., :1],
    }.items()}


def test_fused_pipeline_matches_modular(tables, dat):
    ref = pipeline.conv_properties(dat, tables=tables)
    got = pipeline.conv_properties_fused(dat, tables=tables)
    assert set(got) == set(ref)
    for k in sorted(ref):
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-6, rtol=1e-9, err_msg=k)


def test_min_conv_properties(tables, dat):
    out = pipeline.min_conv_properties(dat, tables=tables)
    expect = {'mixed_100_cape', 'mixed_100_cin', 'mixed_100_lifted_index',
              'lapse_rate_700_500', 'temp_500', 'freezing_level',
              'melting_level', 'shear_u', 'shear_v', 'shear_magnitude',
              'positive_shear'}
    assert expect <= set(out)
    full = pipeline.conv_properties(dat, tables=tables)
    # The reduced pipeline's shared variables must equal the full one's —
    # except it does not NaN-mask invalid columns (reference
    # min_conv_properties has no valid-point mask, :1872-1949).
    valid = ~np.isnan(np.asarray(full['mixed_100_cape']))
    for k in ('mixed_100_cape', 'mixed_100_lifted_index', 'temp_500'):
        np.testing.assert_allclose(np.asarray(out[k])[valid],
                                   np.asarray(full[k])[valid],
                                   atol=1e-6, err_msg=k)


def test_min_conv_properties_fused_matches_modular(tables, dat):
    ref = pipeline.min_conv_properties(dat, tables=tables)
    got = pipeline.min_conv_properties_fused(dat, tables=tables)
    assert set(got) == set(ref)
    for k in sorted(ref):
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-6, rtol=1e-9, err_msg=k)


def test_mix_slot_write_matches_splice(tables, dat):
    """mix_layer(grow=False) writes the mixed parcel into the last
    masked-prefix slot of the ORIGINAL L columns instead of splicing to
    L+1 — same physical profile, so the fused solve and the full fused
    pipeline must agree with the splice variant to fp accumulation."""
    from xarray_parcel_tpu import fused
    from xarray_parcel_tpu.parcels import mix_layer

    p, t = dat['pressure'], dat['temperature']
    from xarray_parcel_tpu import thermo
    dew = thermo.dewpoint_from_specific_humidity(p, t,
                                                 dat['specific_humidity'])
    for depth in (100.0, 50.0):
        spl, mp1 = mix_layer(p, t, dew, depth=depth, grow=True)
        slo, mp2 = mix_layer(p, t, dew, depth=depth, grow=False)
        assert slo['pressure'].shape == p.shape
        assert spl['pressure'].shape == p.shape[:-1] + (p.shape[-1] + 1,)
        for k in mp1:
            np.testing.assert_allclose(np.asarray(mp1[k]),
                                       np.asarray(mp2[k]), atol=0,
                                       equal_nan=True)
        # The slot column = the spliced column minus one leading NaN slot.
        a = np.asarray(spl['pressure'])[:, 1:]
        np.testing.assert_allclose(a, np.asarray(slo['pressure']),
                                   atol=0, equal_nan=True)
        ra, _ = fused.fused_cape_cin(
            spl['pressure'], spl['temperature'], spl['dewpoint'],
            parcel_pressure=mp1['pressure'],
            parcel_temperature=mp1['temperature'],
            parcel_dewpoint=mp1['dewpoint'], tables=tables)
        rb, _ = fused.fused_cape_cin(
            slo['pressure'], slo['temperature'], slo['dewpoint'],
            parcel_pressure=mp2['pressure'],
            parcel_temperature=mp2['temperature'],
            parcel_dewpoint=mp2['dewpoint'], tables=tables)
        for k in ('cape', 'cin'):
            np.testing.assert_allclose(np.asarray(ra[k]), np.asarray(rb[k]),
                                       atol=1e-9, rtol=1e-12,
                                       equal_nan=True, err_msg=f'{depth}/{k}')

    full_a = pipeline.conv_properties_fused(dat, tables=tables,
                                            mix_grow=True)
    full_b = pipeline.conv_properties_fused(dat, tables=tables)
    assert set(full_a) == set(full_b)
    for k in full_a:
        a, b = np.asarray(full_a[k]), np.asarray(full_b[k])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-9, rtol=1e-12, err_msg=k)
