"""xarray shim tests — the Dataset-level mirror of the reference surface.

Runs with real xarray when installed, else with the vendored
``xarray_parcel_tpu.xr_lite`` stub (same duck-typed Dataset/DataArray
shape), so the shim's dim-ordering/transpose/attrs logic is always
exercised.  Mirrors the per-function reference surface
(reference: modules/parcel_functions.py:609, 712, 806, 1066, 1394, 1477,
1557, 1651, 1722, 2216) against the array API as oracle.
"""

import numpy as np
import pytest

from xarray_parcel_tpu import api, thermo, xarray_api

try:
    import xarray as xr
except ImportError:
    from xarray_parcel_tpu import xr_lite as xr


@pytest.fixture(scope='module')
def dat():
    from xarray_parcel_tpu import adiabat
    adiabat.load_moist_adiabat_lookups()
    ny, nx, L = 3, 4, 40
    rng = np.random.default_rng(0)
    p = np.broadcast_to(np.linspace(1005., 200., L), (ny, nx, L)).copy()
    t = 300.0 - 70.0 * (1.0 - (p / 1005.0) ** 0.3) + rng.normal(
        0, 1, (ny, nx, L))
    q = 0.014 * (p / 1005.0) ** 3 + 1e-5
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    dims = ('latitude', 'longitude', 'model_level_number')
    return xr.Dataset(
        {'pressure': (dims, p), 'temperature': (dims, t),
         'specific_humidity': (dims, q), 'height_asl': (dims, h),
         'surface_wind_u': (dims[:2], rng.normal(3, 1, (ny, nx))),
         'surface_wind_v': (dims[:2], rng.normal(0, 1, (ny, nx))),
         'wind_u': (dims, rng.normal(8, 3, (ny, nx, L))),
         'wind_v': (dims, rng.normal(1, 3, (ny, nx, L))),
         'wind_height_above_surface': (dims, h - h[..., :1])},
        coords={'latitude': np.arange(ny) * 1.0,
                'longitude': np.arange(nx) * 1.0,
                'model_level_number': np.arange(1, L + 1)})


@pytest.fixture(scope='module')
def dat_dew(dat):
    import jax.numpy as jnp
    dew = thermo.dewpoint_from_specific_humidity(
        jnp.asarray(dat['pressure'].values),
        jnp.asarray(dat['temperature'].values),
        jnp.asarray(dat['specific_humidity'].values))
    out = dat.copy()
    out['dewpoint'] = (dat['pressure'].dims, np.asarray(dew))
    return out


def test_conv_properties_dataset_roundtrip(dat):
    out = xarray_api.conv_properties(dat)
    assert isinstance(out, xr.Dataset)
    assert out.mu_cape.dims == ('latitude', 'longitude')
    assert 'units' in out.mu_cape.attrs
    assert np.isfinite(np.asarray(out.mu_cape)).all()
    proxies = xarray_api.storm_proxies(out)
    assert 'proxy_Craven2004' in proxies


def test_min_conv_properties_dataset(dat):
    out = xarray_api.min_conv_properties(dat)
    assert 'mixed_100_cape' in out
    assert out.mixed_100_cape.dims == ('latitude', 'longitude')


def test_serve_through_deployed_artifact(dat, tmp_path):
    # Dataset in -> AOT artifact (batch 6; the 3x4 grid flattens to 12
    # columns = pad + 2 chunks) -> attributed Dataset out, equal to the
    # direct Dataset pipeline within the fp32 batch-shape wobble
    # (docs/performance.md).
    from xarray_parcel_tpu import deploy
    import jax.numpy as jnp
    path = tmp_path / 'min40.xpz'
    deploy.export_pipeline('min_conv_properties', batch=6, levels=40,
                           dtype=jnp.float32, path=path)
    ref = xarray_api.min_conv_properties(dat)
    out = xarray_api.serve(dat, path)
    assert isinstance(out, xr.Dataset)
    assert set(out.data_vars) == set(ref.data_vars)
    assert out.mixed_100_cape.dims == ('latitude', 'longitude')
    assert 'units' in out.mixed_100_cape.attrs
    for k in ref.data_vars:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        scale = max(1.0, float(np.nanmax(np.abs(b))) if np.isfinite(
            b).any() else 1.0)
        assert np.nanmax(np.abs(a - b)) <= 1e-4 * scale + 1e-3, k


def test_min_conv_properties_fused_dataset(dat):
    ref = xarray_api.min_conv_properties(dat)
    out = xarray_api.min_conv_properties_fused(dat)
    assert set(out.data_vars) == set(ref.data_vars)
    np.testing.assert_allclose(np.asarray(out.mixed_100_cape),
                               np.asarray(ref.mixed_100_cape),
                               atol=1e-6, equal_nan=True)


def test_surface_cape_fused_vs_unfused(dat_dew):
    a = xarray_api.surface_based_cape_cin_dataset(dat_dew, fused=True)
    b = xarray_api.surface_based_cape_cin_dataset(dat_dew, fused=False)
    np.testing.assert_allclose(np.asarray(a.cape), np.asarray(b.cape),
                               atol=1e-6)


def test_vert_dim_position_irrelevant(dat):
    # Vertical dim first instead of last must give identical results.
    transposed = dat.transpose('model_level_number', 'latitude', 'longitude')
    out1 = xarray_api.conv_properties(dat)
    out2 = xarray_api.conv_properties(transposed)
    np.testing.assert_allclose(np.asarray(out1.mu_cape),
                               np.asarray(out2.mu_cape), atol=1e-6)


def test_jit_cache_reused(dat):
    # Repeated Dataset calls must not retrace: same cached callable.
    xarray_api.conv_properties(dat)
    n = len(xarray_api._JIT_CACHE)
    xarray_api.conv_properties(dat)
    assert len(xarray_api._JIT_CACHE) == n


# --- per-function surface (reference signatures, DataArray in) -----------

def test_lcl_dataarrays(dat_dew):
    p0 = _isel0(dat_dew['pressure'])
    t0 = _isel0(dat_dew['temperature'])
    td0 = _isel0(dat_dew['dewpoint'])
    out = xarray_api.lcl(p0, t0, td0)
    assert out.lcl_pressure.dims == ('latitude', 'longitude')
    assert 'units' in out.lcl_pressure.attrs
    ref = api.lcl(np.asarray(p0.values), np.asarray(t0.values),
                  np.asarray(td0.values))
    np.testing.assert_allclose(np.asarray(out.lcl_pressure),
                               np.asarray(ref['lcl_pressure']), rtol=1e-6)


def _isel0(da):
    """Surface (level-0) slice of a (…, level) DataArray, stub-compatible."""
    dims = tuple(d for d in da.dims if d != 'model_level_number')
    axis = da.dims.index('model_level_number')
    return xr.DataArray(np.asarray(da.values).take(0, axis=axis), dims=dims)


def test_parcel_profile_with_lcl_dataset(dat_dew):
    out = xarray_api.parcel_profile_with_lcl(
        dat_dew['pressure'], dat_dew['temperature'], dat_dew['dewpoint'],
        _isel0(dat_dew['pressure']), _isel0(dat_dew['temperature']),
        _isel0(dat_dew['dewpoint']))
    L = dat_dew.dims['model_level_number']
    assert out.temperature.dims == ('latitude', 'longitude',
                                    'model_level_number')
    assert out.temperature.values.shape[-1] == L + 1
    assert out.lcl_pressure.dims == ('latitude', 'longitude')
    assert 'environment_temperature' in out


def test_lfc_el_dataset(dat_dew):
    prof = xarray_api.parcel_profile_with_lcl(
        dat_dew['pressure'], dat_dew['temperature'], dat_dew['dewpoint'],
        _isel0(dat_dew['pressure']), _isel0(dat_dew['temperature']),
        _isel0(dat_dew['dewpoint']))
    out = xarray_api.lfc_el(prof['pressure'], prof['temperature'],
                            prof['environment_temperature'],
                            prof['lcl_pressure'], prof['lcl_temperature'])
    for v in ('lfc_pressure', 'lfc_temperature', 'el_pressure',
              'el_temperature'):
        assert v in out
        assert out[v].dims == ('latitude', 'longitude')


def test_cape_cin_dataset(dat_dew):
    res, prof = xarray_api.cape_cin(
        dat_dew['pressure'], dat_dew['temperature'], dat_dew['dewpoint'],
        _isel0(dat_dew['temperature']), _isel0(dat_dew['pressure']),
        _isel0(dat_dew['dewpoint']))
    assert res.cape.dims == ('latitude', 'longitude')
    assert 'lfc_pressure' in prof
    r2, _ = xarray_api.surface_based_cape_cin(
        dat_dew['pressure'], dat_dew['temperature'], dat_dew['dewpoint'])
    np.testing.assert_allclose(np.asarray(res.cape), np.asarray(r2.cape),
                               atol=1e-6)


def test_cape_variants_prefix(dat_dew):
    res, prof, parcel = xarray_api.most_unstable_cape_cin(
        dat_dew['pressure'], dat_dew['temperature'], dat_dew['dewpoint'],
        depth=250.0, prefix='mu')
    assert 'mu_cape' in res and 'mu_cin' in res
    assert 'description' in res.mu_cape.attrs
    assert 'temperature' in parcel
    res2, _, _ = xarray_api.mixed_layer_cape_cin(
        dat_dew['pressure'], dat_dew['temperature'], dat_dew['dewpoint'],
        depth=100.0, prefix='mixed_100')
    assert 'mixed_100_cape' in res2


def test_scalar_diagnostics_dataset(dat_dew):
    d = dat_dew
    li_in = xarray_api.parcel_profile_with_lcl(
        d['pressure'], d['temperature'], d['dewpoint'],
        _isel0(d['pressure']), _isel0(d['temperature']),
        _isel0(d['dewpoint']))
    li = xarray_api.lifted_index(li_in, prefix='sb')
    assert 'sb_lifted_index' in li
    dci = xarray_api.deep_convective_index(
        d['pressure'], d['temperature'], d['dewpoint'],
        li['sb_lifted_index'])
    assert 'dci' in dci
    lr = xarray_api.lapse_rate(d['pressure'], d['temperature'],
                               d['height_asl'])
    assert lr.dims == ('latitude', 'longitude')
    t500 = xarray_api.isobar_temperature(d['pressure'], d['temperature'],
                                         500.0)
    assert np.isfinite(np.asarray(t500)).all()
    flh = xarray_api.freezing_level_height(d['temperature'], d['height_asl'])
    assert flh.dims == ('latitude', 'longitude')
    mlh = xarray_api.melting_level_height(d['pressure'], d['temperature'],
                                          d['dewpoint'], d['height_asl'])
    assert mlh.dims == ('latitude', 'longitude')
    shear = xarray_api.wind_shear(
        d['surface_wind_u'], d['surface_wind_v'], d['wind_u'], d['wind_v'],
        d['wind_height_above_surface'])
    assert 'shear_magnitude' in shear
    wbf = xarray_api.wet_bulb_temperature_fast(d['temperature'],
                                               d['dewpoint'])
    assert wbf.values.shape == d['temperature'].values.shape


def test_wet_bulb_exact_dataset(dat_dew):
    sub = xr.Dataset({
        'pressure': (('latitude', 'model_level_number'),
                     np.asarray(dat_dew['pressure'].values)[0, :2]),
        'temperature': (('latitude', 'model_level_number'),
                        np.asarray(dat_dew['temperature'].values)[0, :2]),
        'dewpoint': (('latitude', 'model_level_number'),
                     np.asarray(dat_dew['dewpoint'].values)[0, :2])})
    wb = xarray_api.wet_bulb_temperature(sub['pressure'], sub['temperature'],
                                         sub['dewpoint'])
    assert wb.dims == ('latitude', 'model_level_number')
    v = np.asarray(wb)
    td = np.asarray(sub['dewpoint'].values)
    t = np.asarray(sub['temperature'].values)
    ok = np.isfinite(v)
    assert ok.any()
    assert np.all(v[ok] <= t[ok] + 1e-3)
    assert np.all(v[ok] >= td[ok] - 0.5)


def test_elementwise_wrappers(dat_dew):
    ml = xarray_api.moist_lapse(dat_dew['pressure'],
                                _isel0(dat_dew['temperature']))
    assert ml.dims == dat_dew['pressure'].dims
    dl = xarray_api.dry_lapse(dat_dew['pressure'],
                              _isel0(dat_dew['temperature']))
    assert dl.dims == dat_dew['pressure'].dims
    w = xarray_api.mixing_ratio(dat_dew['temperature'], dat_dew['dewpoint'],
                                dat_dew['pressure'])
    vt = xarray_api.virtual_temperature(dat_dew['temperature'], w)
    assert np.all(np.asarray(vt) >= np.asarray(dat_dew['temperature']) - 1e-6)


def test_valid_data_dataset(dat):
    ok = xarray_api.valid_data(dat)
    assert ok.all()
    bad = dat.copy()
    pv = np.asarray(bad['pressure'].values).copy()
    pv[0, 0, 5] = pv[0, 0, 4] + 10.0   # non-monotonic column
    bad['pressure'] = (bad['pressure'].dims, pv)
    # ValueError, not AssertionError: the contract survives python -O.
    with pytest.raises(ValueError):
        xarray_api.valid_data(bad)
    mask = xarray_api.valid_data(bad, strict=False)
    assert mask.sum() == mask.size - 1


def test_valid_data_vert_coord_increments(dat):
    """The OTHER half of the reference's invariant (reference:
    modules/parcel_functions.py:2316-2319): the vertical index coordinate
    must increment by exactly 1 — raises under strict, all-False mask
    otherwise.  |diff| == 1 (descending unit steps allowed, as in the
    reference's abs())."""
    bad = dat.copy()
    lv = np.asarray(bad.coords['model_level_number'].values).copy()
    lv[5:] += 3   # a gap of 4 between levels 4 and 5
    bad = bad.assign_coords({'model_level_number': lv})
    with pytest.raises(ValueError, match='increments'):
        xarray_api.valid_data(bad)
    mask = xarray_api.valid_data(bad, strict=False)
    assert mask.shape == dat['surface_wind_u'].shape and not mask.any()
    # Descending unit increments satisfy the reference's abs-diff check.
    desc = dat.assign_coords(
        {'model_level_number':
         np.asarray(dat.coords['model_level_number'].values)[::-1].copy()})
    assert xarray_api.valid_data(desc).all()


def test_jitted_unhashable_static_warns():
    """Unhashable static options fall back to per-call re-jits — loudly."""
    import jax.numpy as jnp
    from xarray_parcel_tpu.xarray_api import _jitted

    def f(x, opt=None):
        return x + (0.0 if opt is None else float(opt[0]))

    with pytest.warns(UserWarning, match='re-jits'):
        run = _jitted(f, (('opt', [1.0]),))   # list: unhashable
    assert float(run(jnp.float32(1.0))) == 2.0


def test_conv_properties_streamed(dat):
    # Out-of-core streaming (the dask-chunking analogue) must match the
    # direct whole-grid run exactly.
    direct = xarray_api.conv_properties(dat)
    streamed = xarray_api.conv_properties(dat, stream_columns=5)
    np.testing.assert_allclose(np.asarray(streamed.mu_cape),
                               np.asarray(direct.mu_cape), atol=1e-5,
                               rtol=1e-6)
    assert streamed.mu_cape.dims == direct.mu_cape.dims


def test_dataset_sb_jit_cache_reused(dat_dew):
    # Per-call closures must not defeat the module jit cache (every miss is
    # a 25-110 s remote compile on the target box).
    xarray_api.surface_based_cape_cin_dataset(dat_dew, fused=False)
    n = len(xarray_api._JIT_CACHE)
    xarray_api.surface_based_cape_cin_dataset(dat_dew, fused=False)
    assert len(xarray_api._JIT_CACHE) == n
    xarray_api.melting_level_height(dat_dew['pressure'],
                                    dat_dew['temperature'],
                                    dat_dew['dewpoint'],
                                    dat_dew['height_asl'])
    n = len(xarray_api._JIT_CACHE)
    xarray_api.melting_level_height(dat_dew['pressure'],
                                    dat_dew['temperature'],
                                    dat_dew['dewpoint'],
                                    dat_dew['height_asl'])
    assert len(xarray_api._JIT_CACHE) == n


def test_stream_and_mesh_compose(dat):
    """Out-of-core streaming + mesh sharding compose: each chunk shards
    over the mesh (grids larger than one device's HBM stream through all
    devices), and results equal the direct unsharded run."""
    import jax
    from xarray_parcel_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices('cpu')[:8])
    direct = xarray_api.conv_properties(dat)
    streamed = xarray_api.conv_properties(dat, mesh=mesh, stream_columns=5)
    for k in direct.data_vars:
        np.testing.assert_allclose(
            np.asarray(streamed[k].values), np.asarray(direct[k].values),
            atol=1e-6, rtol=1e-9, equal_nan=True, err_msg=k)


def _vals(x):
    return np.asarray(x.values if hasattr(x, 'values') else x)


def test_ops_level_wrappers(dat_dew):
    """The reference exposes its building blocks as xarray functions
    (reference: modules/parcel_functions.py:63-289, :933-1064, :1699-1828);
    mirror each wrapper against the array API."""
    import jax.numpy as jnp

    p = dat_dew['pressure']
    t = dat_dew['temperature']
    td = dat_dew['dewpoint']
    pj, tj = jnp.asarray(_vals(p)), jnp.asarray(_vals(t))
    tdj = jnp.asarray(_vals(td))

    lay = xarray_api.get_layer(
        xr.Dataset({'pressure': p, 'temperature': t}), depth=100.0)
    ref = api.get_layer({'pressure': pj, 'temperature': tj}, depth=100.0)
    np.testing.assert_allclose(_vals(lay['temperature']),
                               np.asarray(ref['temperature']),
                               equal_nan=True)
    assert _vals(lay['pressure']).shape[-1] == pj.shape[-1] + 1

    ml = xarray_api.mixed_layer(
        xr.Dataset({'pressure': p, 'temperature': t}), depth=100.0)
    ref = api.mixed_layer({'pressure': pj, 'temperature': tj}, depth=100.0)
    np.testing.assert_allclose(_vals(ml['temperature']),
                               np.asarray(ref['temperature']), rtol=1e-6)

    mp = xarray_api.mixed_parcel(p, t, td, depth=100.0)
    ref = api.mixed_parcel(pj, tj, tdj, depth=100.0)
    for k in ('pressure', 'temperature', 'dewpoint'):
        np.testing.assert_allclose(_vals(mp[k]), np.asarray(ref[k]),
                                   rtol=1e-6)

    mu = xarray_api.most_unstable_parcel(p, t, td, depth=300.0)
    ref = api.most_unstable_parcel(pj, tj, tdj, depth=300.0)
    for k in ('pressure', 'temperature', 'dewpoint'):
        np.testing.assert_allclose(_vals(mu[k]), np.asarray(ref[k]),
                                   rtol=1e-6)

    ints = xarray_api.find_intersections(p, t, td, log_x=True)
    ref = api.find_intersections(pj, tj, tdj, log_x=True)
    np.testing.assert_allclose(_vals(ints['all_x']),
                               np.asarray(ref['all_x']), equal_nan=True,
                               rtol=1e-6)

    tz = xarray_api.trapz(t, p)
    np.testing.assert_allclose(_vals(tz), np.asarray(api.trapz(tj, pj)),
                               rtol=1e-6)

    li = xarray_api.log_interp(t, p, 850.0)
    np.testing.assert_allclose(_vals(li),
                               np.asarray(api.log_interp(tj, pj, 850.0)),
                               rtol=1e-6)
    li2 = xarray_api.linear_interp(t, p, 850.0)
    np.testing.assert_allclose(_vals(li2),
                               np.asarray(api.linear_interp(tj, pj, 850.0)),
                               rtol=1e-6)


def test_insert_level_and_shift_out_nans_wrappers(dat_dew):
    import jax.numpy as jnp

    p = dat_dew['pressure']
    t = dat_dew['temperature']
    pj, tj = jnp.asarray(_vals(p)), jnp.asarray(_vals(t))
    batch = pj.shape[:-1]

    lvl_p = np.full(batch, 900.0)
    lvl_t = np.full(batch, 285.0)
    in_vc_ds = _vals(dat_dew.coords['model_level_number'])
    out = xarray_api.insert_level(
        xr.Dataset({'pressure': p, 'temperature': t},
                   coords={'model_level_number': in_vc_ds}),
        {'pressure': lvl_p, 'temperature': lvl_t})
    ref = api.insert_level({'pressure': pj, 'temperature': tj},
                           {'pressure': jnp.asarray(lvl_p),
                            'temperature': jnp.asarray(lvl_t)})
    np.testing.assert_allclose(_vals(out['temperature']),
                               np.asarray(ref['temperature']),
                               equal_nan=True)
    # The spliced output keeps a vertical index coordinate, extended by one
    # (the reference's reindexing; modules/parcel_functions.py:977-988).
    vc = _vals(out.coords['model_level_number'])
    in_vc = _vals(dat_dew.coords['model_level_number'])
    assert len(vc) == len(in_vc) + 1
    np.testing.assert_array_equal(vc[:-1], in_vc)
    assert vc[-1] == in_vc[-1] + 1

    # shift_out_nans round-trips a leading-NaN column to compacted form.
    pn = _vals(p).copy()
    tn = _vals(t).copy()
    pn[0, 0, :2] = np.nan
    tn[0, 0, :2] = np.nan
    dims = p.dims
    sh = xarray_api.shift_out_nans(
        xr.Dataset({'pressure': (dims, pn), 'temperature': (dims, tn)}),
        key='pressure')
    ref = api.shift_out_nans({'pressure': jnp.asarray(pn),
                              'temperature': jnp.asarray(tn)},
                             key='pressure')
    np.testing.assert_allclose(_vals(sh['pressure']),
                               np.asarray(ref['pressure']), equal_nan=True)


def test_profile_outputs_carry_vert_coord(dat_dew):
    in_vc = _vals(dat_dew.coords['model_level_number'])
    dims = dat_dew['pressure'].dims

    def with_vc(name):
        return xr.DataArray(_vals(dat_dew[name]), dims=dims,
                            coords={'model_level_number': in_vc})

    def surf(name):
        return xr.DataArray(_vals(dat_dew[name])[..., 0], dims=dims[:-1])

    prof = xarray_api.parcel_profile_with_lcl(
        with_vc('pressure'), with_vc('temperature'), with_vc('dewpoint'),
        surf('pressure'), surf('temperature'), surf('dewpoint'))
    vc = _vals(prof.coords['model_level_number'])
    assert len(vc) == len(in_vc) + 1          # LCL splice adds one level
    np.testing.assert_array_equal(vc[:-1], in_vc)
    assert vc[-1] == in_vc[-1] + 1


def test_ops_wrappers_subset_to_level_vars(dat):
    # A full input Dataset carries surface (non-level) variables; the
    # ops-level wrappers operate on the level-carrying subset instead of
    # crashing on the shape mismatch.
    gl = xarray_api.get_layer(dat, depth=100.0)
    assert 'surface_wind_u' not in gl.data_vars
    assert gl['pressure'].values.shape[-1] == \
        dat['pressure'].values.shape[-1] + 1
    ml = xarray_api.mixed_layer(dat, depth=100.0)
    assert 'surface_wind_u' not in ml.data_vars
    assert np.isfinite(_vals(ml['temperature'])).all()
    # Explicit selection still works.
    ml2 = xarray_api.mixed_layer(dat, depth=100.0,
                                 names=['pressure', 'temperature'])
    assert sorted(ml2.data_vars) == ['temperature']
    np.testing.assert_allclose(_vals(ml2['temperature']),
                               _vals(ml['temperature']))
    with pytest.raises(ValueError, match='vertical dim'):
        xarray_api.mixed_layer(dat, vert_dim='no_such_dim')


def test_spliced_vert_coord_follows_input_step(dat_dew):
    # Descending / non-unit vertical index coordinates extend by their own
    # step on L+1 outputs, staying monotonic and duplicate-free.
    dims = dat_dew['pressure'].dims
    L = dat_dew['pressure'].values.shape[-1]
    for vc_in in (np.arange(L, 0, -1), np.arange(0, 10 * L, 10)):
        def with_vc(name):
            return xr.DataArray(_vals(dat_dew[name]), dims=dims,
                                coords={'model_level_number': vc_in})
        gl = xarray_api.get_layer(
            {'pressure': with_vc('pressure'),
             'temperature': with_vc('temperature')}, depth=100.0)
        vc = gl.coords['model_level_number']
        vc = np.asarray(vc.values if hasattr(vc, 'values') else vc)
        assert len(vc) == L + 1
        np.testing.assert_array_equal(vc[:-1], vc_in)
        assert vc[-1] == vc_in[-1] + (vc_in[-1] - vc_in[-2])
        assert len(np.unique(vc)) == L + 1


def test_remaining_ops_wrappers_mirror_array_api(dat_dew):
    """The last reference defs exposed on the Dataset surface
    (bound_pressure, trap_around_zeros, cape_cin_base, add_lcl_to_profile,
    from_most_unstable_parcel, mix_layer) match the array API."""
    import jax.numpy as jnp

    dims = dat_dew['pressure'].dims
    p, t, td = (_vals(dat_dew[k]) for k in ('pressure', 'temperature',
                                            'dewpoint'))
    P, T, TD = (xr.DataArray(v, dims=dims) for v in (p, t, td))
    jp, jt, jtd = (jnp.asarray(v) for v in (p, t, td))

    bound = np.full(p.shape[:-1], 850.0)
    bp = xarray_api.bound_pressure(P, xr.DataArray(bound, dims=dims[:-1]))
    np.testing.assert_allclose(_vals(bp), np.asarray(
        api.bound_pressure(jp, jnp.asarray(bound))), rtol=1e-6)

    y = t - (t[..., :1] - 30.0 * (1.0 - p / p[..., :1]))
    areas, mask = xarray_api.trap_around_zeros(P,
                                               xr.DataArray(y, dims=dims))
    a_ref, m_ref = api.trap_around_zeros(jp, jnp.asarray(y))
    np.testing.assert_allclose(_vals(areas['area']),
                               np.asarray(a_ref['area']), rtol=1e-6,
                               equal_nan=True)
    np.testing.assert_array_equal(_vals(mask), np.asarray(m_ref))

    fields, parcel = xarray_api.mix_layer(P, T, TD)
    f_ref, p_ref = api.mix_layer(jp, jt, jtd)
    assert _vals(fields['pressure']).shape[-1] == p.shape[-1] + 1
    np.testing.assert_allclose(_vals(fields['temperature']),
                               np.asarray(f_ref['temperature']),
                               rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(_vals(parcel['temperature']),
                               np.asarray(p_ref['temperature']), rtol=1e-6)

    fields2, mu = xarray_api.from_most_unstable_parcel(P, T, TD)
    f2_ref, mu_ref = api.from_most_unstable_parcel(jp, jt, jtd)
    np.testing.assert_allclose(_vals(fields2['pressure']),
                               np.asarray(f2_ref['pressure']), rtol=1e-6,
                               equal_nan=True)
    np.testing.assert_allclose(_vals(mu['pressure']),
                               np.asarray(mu_ref['pressure']), rtol=1e-6)

    surf = {k: xr.DataArray(v[..., 0], dims=dims[:-1])
            for k, v in (('p', p), ('t', t), ('td', td))}
    prof = xarray_api.parcel_profile(P, surf['p'], surf['t'], surf['td'])
    spliced = xarray_api.add_lcl_to_profile(prof)
    prof_ref = api.parcel_profile(jp, jnp.asarray(p[..., 0]),
                                  jnp.asarray(t[..., 0]),
                                  jnp.asarray(td[..., 0]))
    spl_ref = api.add_lcl_to_profile(prof_ref)
    np.testing.assert_allclose(_vals(spliced['temperature']),
                               np.asarray(spl_ref['temperature']),
                               rtol=1e-6, equal_nan=True)

    ccb = xarray_api.cape_cin_base(
        spliced['pressure'], spliced['virtual_temperature'],
        xr.DataArray(np.full(p.shape[:-1], 900.0), dims=dims[:-1]),
        xr.DataArray(np.full(p.shape[:-1], 300.0), dims=dims[:-1]),
        spliced['virtual_temperature'])
    assert sorted(ccb.data_vars) == ['cape', 'cin']

    assert float(xarray_api.round_to(123.456, 0.5)) == 123.5
    assert xarray_api.lookup_tables_loaded()


def test_description_override_lands_on_renamed_key(dat_dew):
    """``description=`` must annotate the RENAMED output variable when a
    prefix is in play (the reference threads description= through to the
    attrs of the prefixed name — modules/parcel_functions.py:1722-1756,
    1830-1870), on both the Dataset and the array surfaces."""
    d = dat_dew
    li_in = xarray_api.parcel_profile_with_lcl(
        d['pressure'], d['temperature'], d['dewpoint'],
        _isel0(d['pressure']), _isel0(d['temperature']),
        _isel0(d['dewpoint']))
    li = xarray_api.lifted_index(li_in, prefix='sb', description='custom LI')
    assert li.sb_lifted_index.attrs['description'] == 'custom LI'
    dci = xarray_api.deep_convective_index(
        d['pressure'], d['temperature'], d['dewpoint'],
        li['sb_lifted_index'], prefix='sb', description='custom DCI')
    assert dci.sb_dci.attrs['description'] == 'custom DCI'

    # Array-level facade: FieldSet attrs carry the same override.
    import jax.numpy as jnp
    prof = {k: jnp.asarray(np.asarray(v.values))
            for k, v in li_in.data_vars.items()}
    res = api.lifted_index(prof, prefix='sb', description='custom LI')
    assert res.attrs['sb_lifted_index']['description'] == 'custom LI'
    # Without an override, an arbitrary prefix keeps the base attrs (the
    # reference renames AFTER attaching long_name/units) and gains no
    # description.
    res2 = api.lifted_index(prof, prefix='sb')
    a = res2.attrs['sb_lifted_index']
    assert a['long_name'] == 'Lifted index' and a['units'] == 'K'
    assert 'description' not in a


def test_fieldset_is_a_pytree():
    """API outputs must feed straight back into jit/sharding/sync: a
    FieldSet traverses as a dict pytree (leaf FieldSets would make jit
    raise and utils.sync skip waiting for the device)."""
    import jax
    import jax.numpy as jnp
    from xarray_parcel_tpu.fieldset import FieldSet

    fs = FieldSet({'cape': jnp.arange(3.0), 'cin': jnp.ones(3)},
                  _attr_overrides={'cape': 'custom'})
    leaves = jax.tree_util.tree_leaves(fs)
    assert len(leaves) == 2
    out = jax.jit(lambda d: {k: v * 2 for k, v in d.items()})(fs)
    np.testing.assert_array_equal(np.asarray(out['cape']), [0., 2., 4.])
    # Round-tripping through flatten/unflatten keeps the overrides.
    flat, treedef = jax.tree_util.tree_flatten(fs)
    back = jax.tree_util.tree_unflatten(treedef, flat)
    assert isinstance(back, FieldSet)
    assert back.attrs['cape']['description'] == 'custom'


def test_dataset_mesh_whole_grid_matches_direct(dat):
    """conv_properties(dat, mesh=): the whole grid ingests sharded over
    the mesh (from_dataset -> shard_batch) and matches the unsharded run."""
    import jax
    from xarray_parcel_tpu.parallel import make_mesh

    # from_dataset shards the LEADING batch dim (latitude=3) over the
    # mesh; here the mesh size divides it exactly (no padding involved).
    mesh = make_mesh(jax.devices('cpu')[:3])
    direct = xarray_api.conv_properties(dat)
    sharded = xarray_api.conv_properties(dat, mesh=mesh)
    for k in direct.data_vars:
        np.testing.assert_allclose(
            np.asarray(sharded[k].values), np.asarray(direct[k].values),
            atol=1e-6, rtol=1e-9, equal_nan=True, err_msg=k)


def test_dataset_mesh_nondivisible_grid_pads_and_matches(dat):
    """conv_properties(dat, mesh=) on a grid the mesh does NOT divide:
    the pipeline pads the leading batch dim to a mesh multiple, computes
    sharded, and slices the padding off — outputs equal the unsharded run
    bit-for-bit on values and NaN pattern.  The reference's dask chunking
    accepts arbitrary grids the same way (reference:
    modules/parcel_functions.py:561-579; its own eval grid is 101x101)."""
    import jax
    from xarray_parcel_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices('cpu')[:8])     # latitude=3: 8 ∤ 3
    direct = xarray_api.conv_properties(dat)
    sharded = xarray_api.conv_properties(dat, mesh=mesh)
    for k in direct.data_vars:
        a = np.asarray(direct[k].values)
        b = np.asarray(sharded[k].values)
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_array_equal(np.where(np.isnan(a), 0.0, a),
                                      np.where(np.isnan(b), 0.0, b),
                                      err_msg=k)
    # Coordinates survive at the ORIGINAL grid shape.
    assert sharded['mu_cape'].dims == direct['mu_cape'].dims


def test_from_dataset_nondivisible_mesh_raises(dat):
    """Direct from_dataset(mesh=) keeps the divisibility contract (it
    returns fields at the input batch shape) but fails loudly with a
    pointer at the auto-padding pipeline path."""
    import jax
    from xarray_parcel_tpu.parallel import make_mesh

    mesh = make_mesh(jax.devices('cpu')[:8])
    with pytest.raises(ValueError, match='pad'):
        xarray_api.from_dataset(dat, mesh=mesh)


def test_serve_subsets_to_artifact_contract(dat, dat_dew, tmp_path):
    """serve() must reconcile the Dataset against the artifact's fixed
    input contract: recognized-but-unexported variables (dewpoint) drop,
    missing required ones raise a clear ValueError."""
    from xarray_parcel_tpu import deploy
    import jax.numpy as jnp
    path = tmp_path / 'min40b.xpz'
    deploy.export_pipeline('min_conv_properties', batch=6, levels=40,
                           dtype=jnp.float32, path=path)
    ref = xarray_api.serve(dat, path)
    out = xarray_api.serve(dat_dew, path)    # extra dewpoint variable
    for k in ref.data_vars:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(ref[k]), err_msg=k)
    # A Dataset missing required artifact inputs fails with the missing
    # names, not jax.export's pytree-structure error.
    slim = xr.Dataset({k: (dat[k].dims, np.asarray(dat[k].values))
                       for k in ('pressure', 'temperature',
                                 'specific_humidity')})
    with pytest.raises(ValueError, match='missing variables'):
        xarray_api.serve(slim, path)


def test_serve_broadcasts_partial_batch_dims(dat, tmp_path):
    """A variable carrying only a subset of the batch dims (time-invariant
    surface winds on a time+lat+lon grid) broadcasts to the full batch
    before flattening, matching the direct pipeline's jnp broadcasting."""
    from xarray_parcel_tpu import deploy
    import jax.numpy as jnp
    nt = 2
    tdims = ('time',) + dat['pressure'].dims
    ds = xr.Dataset(
        {k: (tdims, np.broadcast_to(np.asarray(dat[k].values),
                                    (nt,) + dat[k].values.shape).copy())
         for k in ('pressure', 'temperature', 'specific_humidity',
                   'height_asl', 'wind_u', 'wind_v',
                   'wind_height_above_surface')} |
        {k: (dat[k].dims, np.asarray(dat[k].values))
         for k in ('surface_wind_u', 'surface_wind_v')},
        coords={'time': np.arange(nt) * 1.0,
                'latitude': np.asarray(dat.coords['latitude'].values),
                'longitude': np.asarray(dat.coords['longitude'].values),
                'model_level_number': np.arange(1, 41)})
    path = tmp_path / 'min40c.xpz'
    deploy.export_pipeline('min_conv_properties', batch=6, levels=40,
                           dtype=jnp.float32, path=path)
    out = xarray_api.serve(ds, path)
    assert out['mixed_100_cape'].dims == ('time', 'latitude', 'longitude')
    a = np.asarray(out['mixed_100_cape'])
    # Time slices are copies of the same grid -> identical results.
    np.testing.assert_array_equal(a[0], a[1])
    ref = xarray_api.serve(dat, path)
    np.testing.assert_array_equal(a[0], np.asarray(ref['mixed_100_cape']))


def test_storm_proxies_normalizes_dim_order(dat):
    conv = xarray_api.conv_properties(dat)
    ref = xarray_api.storm_proxies(conv)
    # Permute one variable's dims (legal in xarray) — results must not
    # silently misalign.
    perm = conv.copy()
    perm['lapse_rate_700_500'] = conv['lapse_rate_700_500'].transpose(
        'longitude', 'latitude')
    out = xarray_api.storm_proxies(perm)
    for k in ref.data_vars:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(ref[k]), err_msg=k)


def test_valid_data_non_numeric_coord(dat):
    bad = dat.copy()
    bad.coords['model_level_number'] = np.array(
        ['L%d' % i for i in range(40)])
    assert not xarray_api.valid_data(bad, strict=False).any()
    with pytest.raises(ValueError, match='increments'):
        xarray_api.valid_data(bad, strict=True)


def test_from_dataset_unrecognized_variables():
    ds = xr.Dataset({'temp': (('x',), np.arange(3.0))})
    with pytest.raises(ValueError, match='recognized'):
        xarray_api.from_dataset(ds)


def test_single_column_dataset_rejects_mesh():
    import jax
    from xarray_parcel_tpu.parallel import make_mesh
    L = 40
    p = np.linspace(1005., 200., L)
    t = 300.0 - 70.0 * (1.0 - (p / 1005.0) ** 0.3)
    q = 0.014 * (p / 1005.0) ** 3 + 1e-5
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    dims = ('model_level_number',)
    one = xr.Dataset(
        {'pressure': (dims, p), 'temperature': (dims, t),
         'specific_humidity': (dims, q), 'height_asl': (dims, h),
         'surface_wind_u': ((), np.float64(3.0)),
         'surface_wind_v': ((), np.float64(1.0)),
         'wind_u': (dims, np.full(L, 8.0)),
         'wind_v': (dims, np.full(L, 1.0)),
         'wind_height_above_surface': (dims, h - h[0])},
        coords={'model_level_number': np.arange(1, L + 1)})
    mesh = make_mesh(jax.devices('cpu')[:8])
    with pytest.raises(ValueError, match='batch'):
        xarray_api.min_conv_properties(one, mesh=mesh)
    with pytest.raises(ValueError, match='batch'):
        xarray_api.from_dataset(one, mesh=mesh)


def test_xr_lite_merge_keeps_dataarray_coords():
    from xarray_parcel_tpu import xr_lite
    da = xr_lite.DataArray(np.arange(6.0).reshape(2, 3), ('y', 'x'),
                           coords={'y': xr_lite.DataArray(
                               np.array([10., 20.]), ('y',), name='y')},
                           name='field')
    ds = xr_lite.merge([xr_lite.Dataset(), da])
    assert 'field' in ds.data_vars
    assert 'y' in ds.coords
    np.testing.assert_array_equal(np.asarray(ds.coords['y'].values),
                                  [10., 20.])


def test_xr_lite_assign_coords_shares_data():
    from xarray_parcel_tpu import xr_lite
    base = np.arange(4.0)
    ds = xr_lite.Dataset({'v': (('x',), base)})
    out = ds.assign_coords(x=np.arange(4))
    assert out['v'].values is ds['v'].values  # shared, not deep-copied


def test_from_dataset_union_batch_dims(dat):
    """batch_dims is the union of non-vertical dims over ALL selected
    variables, not the dims of whichever variable happens to come first:
    a 1-D pressure coordinate-variable next to full-grid temperature must
    still yield the grid's batch dims (and serve() must broadcast it)."""
    ds = xr.Dataset(
        {'pressure': (('model_level_number',),
                      np.asarray(dat['pressure'].values)[0, 0])} |
        {k: (dat[k].dims, np.asarray(dat[k].values))
         for k in dat.data_vars if k != 'pressure'},
        coords={d: np.asarray(dat.coords[d].values) for d in dat.coords})
    fields, batch_dims = xarray_api.from_dataset(ds)
    assert batch_dims == ('latitude', 'longitude')
    assert fields['pressure'].shape == (40,)
    assert fields['temperature'].shape == (3, 4, 40)


def test_serve_broadcasts_1d_pressure(dat, tmp_path):
    """End-to-end serve() on the 1-D-pressure Dataset: flat_one broadcasts
    the (L,) pressure onto the full batch and results equal serving the
    broadcast grid."""
    from xarray_parcel_tpu import deploy
    import jax.numpy as jnp
    ds = xr.Dataset(
        {'pressure': (('model_level_number',),
                      np.asarray(dat['pressure'].values)[0, 0])} |
        {k: (dat[k].dims, np.asarray(dat[k].values))
         for k in dat.data_vars if k != 'pressure'},
        coords={d: np.asarray(dat.coords[d].values) for d in dat.coords})
    path = tmp_path / 'min40u.xpz'
    deploy.export_pipeline('min_conv_properties', batch=6, levels=40,
                           dtype=jnp.float32, path=path)
    out = xarray_api.serve(ds, path)
    ref = xarray_api.serve(dat, path)
    for k in ref.data_vars:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(ref[k]), err_msg=k)


def test_serve_f64_artifact_is_not_f32_rounded(dat, tmp_path):
    """Serving an f64 artifact must compute on f64 inputs end to end: the
    Dataset lowers at the artifact dtype (the default f32 repack would
    silently round) and results match the raw-array f64 pipeline at f64
    tolerance, which f32-rounded inputs cannot."""
    from xarray_parcel_tpu import adiabat, deploy, pipeline
    import jax.numpy as jnp
    tables = adiabat.load_moist_adiabat_lookups()
    path = tmp_path / 'min40f64.xpz'
    deploy.export_pipeline('min_conv_properties', batch=12, levels=40,
                           dtype=jnp.float64, tables=tables, path=path)
    out = xarray_api.serve(dat, path)
    raw = {k: np.asarray(dat[k].values, np.float64).reshape(
               (-1,) + np.asarray(dat[k].values).shape[2:])
           for k in dat.data_vars}
    ref = pipeline.min_conv_properties(raw, tables=tables)
    for k, v in ref.items():
        a = np.asarray(out[k]).reshape(np.shape(v))
        b = np.asarray(v)
        assert a.dtype == b.dtype == np.float64 or a.dtype == bool, k
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


def test_serve_f64_artifact_without_x64_raises(dat, tmp_path, monkeypatch):
    """With x64 off, serving an f64 artifact names the remedy instead of
    failing jax.export's dtype check (serve() must not flip process-wide
    dtype semantics itself)."""
    import jax
    from xarray_parcel_tpu import adiabat, deploy
    import jax.numpy as jnp
    tables = adiabat.load_moist_adiabat_lookups()
    path = tmp_path / 'min40f64b.xpz'
    deploy.export_pipeline('min_conv_properties', batch=12, levels=40,
                           dtype=jnp.float64, tables=tables, path=path)
    jax.config.update('jax_enable_x64', False)
    try:
        with pytest.raises(ValueError, match='jax_enable_x64'):
            xarray_api.serve(dat, path)
    finally:
        jax.config.update('jax_enable_x64', True)


def test_storm_proxies_subsets_merged_dataset(dat):
    """A conv_properties output merged with extra (even level-carrying)
    variables computes identical proxies — extras must not reach the
    jitted program (retrace per variable set) or the transpose (an
    incomplete dim permutation on real xarray).  Missing required inputs
    raise with their names."""
    conv = xarray_api.conv_properties(dat)
    ref = xarray_api.storm_proxies(conv)
    merged = conv.copy()
    merged['temperature'] = (dat['temperature'].dims,
                             np.asarray(dat['temperature'].values))
    out = xarray_api.storm_proxies(merged)
    for k in ref.data_vars:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(ref[k]), err_msg=k)
    slim = xr.Dataset({'mu_cape': (conv['mu_cape'].dims,
                                   np.asarray(conv['mu_cape'].values))})
    with pytest.raises(ValueError, match='shear_magnitude'):
        xarray_api.storm_proxies(slim)


@pytest.fixture(scope='module')
def dat_mixed_dims(dat):
    """The same grid with a 1-D pressure coordinate-variable and
    time-invariant-style surface winds carrying only the trailing batch
    dim — the mixed-dims layout real archives use."""
    p1 = dat['pressure'].values[0, 0]           # levels are uniform here
    out = xr.Dataset(
        {'pressure': (('model_level_number',), p1),
         'temperature': (dat['temperature'].dims,
                         np.asarray(dat['temperature'].values)),
         'specific_humidity': (dat['specific_humidity'].dims,
                               np.asarray(dat['specific_humidity'].values)),
         'height_asl': (dat['height_asl'].dims,
                        np.asarray(dat['height_asl'].values)),
         'surface_wind_u': (('longitude',),
                            np.asarray(dat['surface_wind_u'].values)[0]),
         'surface_wind_v': (('longitude',),
                            np.asarray(dat['surface_wind_v'].values)[0]),
         'wind_u': (dat['wind_u'].dims, np.asarray(dat['wind_u'].values)),
         'wind_v': (dat['wind_v'].dims, np.asarray(dat['wind_v'].values)),
         'wind_height_above_surface': (
             dat['wind_height_above_surface'].dims,
             np.asarray(dat['wind_height_above_surface'].values))},
        coords={'latitude': np.asarray(dat.coords['latitude'].values),
                'longitude': np.asarray(dat.coords['longitude'].values),
                'model_level_number': np.asarray(
                    dat.coords['model_level_number'].values)})
    # The reference equivalent: everything broadcast to the full grid.
    full = dat.copy()
    full['surface_wind_u'] = (('latitude', 'longitude'), np.broadcast_to(
        np.asarray(dat['surface_wind_u'].values)[:1],
        dat['surface_wind_u'].shape).copy())
    full['surface_wind_v'] = (('latitude', 'longitude'), np.broadcast_to(
        np.asarray(dat['surface_wind_v'].values)[:1],
        dat['surface_wind_v'].shape).copy())
    return out, full


def _assert_wobble_equal(out, ref):
    """Equality up to XLA program-shape wobble: the mixed-dims path
    broadcasts subset-dim fields at TRACE time (so only their own bytes
    cross to the device), which compiles a different — fused — program
    than dense full-grid inputs; crossing-derived outputs may wobble at
    the re-fusion level (same class as the documented batch-shape wobble,
    docs/performance.md).  NaN patterns must match exactly."""
    for k in ref.data_vars:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   rtol=1e-4, atol=1e-9, err_msg=k)


def test_mixed_dims_dataset_pipeline_matches_broadcast(dat_mixed_dims):
    """A 1-D pressure coordinate-variable + subset-dim surface winds
    compute as the fully-broadcast grid (the reference relies on xarray
    auto-broadcast for this layout), up to program-shape wobble."""
    mixed, full = dat_mixed_dims
    ref = xarray_api.conv_properties(full)
    out = xarray_api.conv_properties(mixed)
    _assert_wobble_equal(out, ref)


def test_mixed_dims_mesh_ingest_matches_direct(dat_mixed_dims):
    """conv_properties(mixed-dims dat, mesh=): subset-dim variables
    broadcast to the full batch BEFORE the leading axis shards — a 1-D
    pressure must never have its LEVEL axis split across devices."""
    import jax
    from xarray_parcel_tpu.parallel import make_mesh
    mixed, _ = dat_mixed_dims
    ref = xarray_api.conv_properties(mixed)
    mesh = make_mesh(jax.devices('cpu')[:3])
    out = xarray_api.conv_properties(mixed, mesh=mesh)
    _assert_wobble_equal(out, ref)


def test_mixed_dims_stream_ingest_matches_direct(dat_mixed_dims):
    """conv_properties(mixed-dims dat, stream_columns=): chunking a
    subset-dim grid broadcasts to the full batch first (host views), so
    chunk boundaries never split a non-batch axis; streamed equals the
    plain mixed-dims run up to batch-shape recompile wobble."""
    mixed, _ = dat_mixed_dims
    ref = xarray_api.conv_properties(mixed)
    out = xarray_api.conv_properties(mixed, stream_columns=5)
    for k in ref.data_vars:
        a, b = np.asarray(out[k]), np.asarray(ref[k])
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   rtol=1e-4, atol=1e-9, err_msg=k)


def test_mixed_dims_per_function_surface(dat_mixed_dims):
    """The per-function surface lays out mixed-dims arguments by the
    UNION of batch dims (1-D pressure next to 3-D temperature)."""
    mixed, full = dat_mixed_dims
    dew_f = xarray_api.dewpoint_from_specific_humidity(
        full['pressure'], full['temperature'], full['specific_humidity'])
    dew_m = xarray_api.dewpoint_from_specific_humidity(
        mixed['pressure'], mixed['temperature'], mixed['specific_humidity'])
    assert np.asarray(dew_m).shape == np.asarray(dew_f).shape
    np.testing.assert_allclose(np.asarray(dew_m), np.asarray(dew_f),
                               rtol=0, atol=0)
    res_f, *_ = xarray_api.most_unstable_cape_cin(
        full['pressure'], full['temperature'], dew_f, prefix='mu')
    res_m, *_ = xarray_api.most_unstable_cape_cin(
        mixed['pressure'], mixed['temperature'], dew_m, prefix='mu')
    np.testing.assert_allclose(np.asarray(res_m['mu_cape']),
                               np.asarray(res_f['mu_cape']),
                               rtol=0, atol=0)


def test_pipeline_ignores_provided_dewpoint(dat_dew):
    """The registry pipelines derive dewpoint from specific humidity and
    never read a provided 'dewpoint' variable — a (deliberately wrong)
    dewpoint in the Dataset must neither change results nor be shipped."""
    ref = xarray_api.conv_properties(dat_dew)
    poisoned = dat_dew.copy()
    poisoned['dewpoint'] = (dat_dew['dewpoint'].dims,
                            np.full_like(
                                np.asarray(dat_dew['dewpoint'].values),
                                9999.0))
    out = xarray_api.conv_properties(poisoned)
    for k in ref.data_vars:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(ref[k]), err_msg=k)


def test_diagnostic_names_follow_parameters(dat):
    """lapse_rate/isobar_temperature output names track the pressures
    actually used (reference defaults keep the reference names)."""
    da = xarray_api.isobar_temperature(dat['pressure'], dat['temperature'],
                                       isobar=500.0)
    assert da.name == 'temp_500'
    da850 = xarray_api.isobar_temperature(dat['pressure'],
                                          dat['temperature'], isobar=850.0)
    assert da850.name == 'temp_850'
    lr = xarray_api.lapse_rate(dat['pressure'], dat['temperature'],
                               dat['height_asl'])
    assert lr.name == 'lapse_rate_700_500'
    lr2 = xarray_api.lapse_rate(dat['pressure'], dat['temperature'],
                                dat['height_asl'], from_pressure=850.0,
                                to_pressure=700.0)
    assert lr2.name == 'lapse_rate_850_700'


def test_dewpoint_wrappers_consistent(dat):
    """dewpoint_from_relative_humidity inverts the RH the q-route
    computes: chaining RH -> dewpoint reproduces the q-route dewpoint."""
    from xarray_parcel_tpu import thermo
    import jax.numpy as jnp
    p = np.asarray(dat['pressure'].values)
    t = np.asarray(dat['temperature'].values)
    q = np.asarray(dat['specific_humidity'].values)
    dew_q = xarray_api.dewpoint_from_specific_humidity(
        dat['pressure'], dat['temperature'], dat['specific_humidity'])
    rh = np.asarray(thermo.relative_humidity_from_specific_humidity(
        jnp.asarray(p), jnp.asarray(t), jnp.asarray(q)))
    dew_rh = xarray_api.dewpoint_from_relative_humidity(
        dat['temperature'], xr.DataArray(rh, dims=dat['temperature'].dims))
    assert dew_rh.name == 'dewpoint'
    np.testing.assert_allclose(np.asarray(dew_rh), np.asarray(dew_q),
                               rtol=1e-12)


def test_parameterized_diagnostic_attrs(dat):
    """Non-default isobar/lapse outputs keep units/long_name, with the
    actual pressures substituted into the description (attrs_for pattern
    match — only temp_500/lapse_rate_700_500 are registered verbatim)."""
    from xarray_parcel_tpu.fieldset import attrs_for
    a = attrs_for('temp_850')
    assert a['units'] == 'K' and a['long_name'] == 'Isobar temperature'
    assert '850' in a['description']
    a = attrs_for('lapse_rate_850_700')
    assert a['long_name'] == 'Lapse rate' and '850' in a['description'] \
        and '700' in a['description']
    # The pattern only matches numeric-parameterized names.
    assert attrs_for('temp_hot') == {}
    # End to end: the lifted DataArray carries the pattern attrs.
    da850 = xarray_api.isobar_temperature(dat['pressure'],
                                          dat['temperature'], isobar=850.0)
    assert da850.attrs.get('units') == 'K'
    assert '850' in da850.attrs.get('description', '')


def test_ops_names_filter_applies_to_dicts(dat):
    """get_layer(dict, names=...) excludes unrequested variables for
    plain-dict input just as it does for Datasets."""
    das = {'pressure': dat['pressure'], 'temperature': dat['temperature'],
           'bogus_extra': dat['surface_wind_u']}
    out = xarray_api.get_layer(das, depth=100.0,
                               names=['pressure', 'temperature'])
    assert 'bogus_extra' not in getattr(out, 'data_vars', out)
