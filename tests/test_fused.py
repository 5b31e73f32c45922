"""Fused CAPE/CIN column program vs the modular XLA path.

The fused solve reuses the same column ops, so agreement must be exact up
to float associativity.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import adiabat, cape, fused


@pytest.fixture(scope='module')
def tables():
    return adiabat.load_moist_adiabat_lookups()


def _grid(B=96, L=48, seed=3):
    rng = np.random.default_rng(seed)
    p = np.linspace(1010.0, 150.0, L)
    p = np.broadcast_to(p, (B, L)) + rng.normal(0, 0.4, (B, L))
    p = -np.sort(-p, axis=-1)
    t = 302.0 - 76.0 * (1.0 - (p / 1010.0) ** 0.3) + rng.normal(0, 2, (B, L))
    td = t - np.abs(rng.normal(2.0, 2.0, (B, L))) - 0.2 \
        - 15.0 * (1.0 - p / 1010.0) ** 2
    return jnp.asarray(p), jnp.asarray(t), jnp.asarray(td)


def test_fused_matches_unfused(tables):
    p, t, td = _grid()
    res_f, sol_f = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    res_u, prof = cape.surface_based_cape_cin(p, t, td, tables=tables)
    np.testing.assert_allclose(np.asarray(res_f['cape']),
                               np.asarray(res_u['cape']), atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_f['cin']),
                               np.asarray(res_u['cin']), atol=1e-6)
    for k in ('lfc_pressure', 'el_pressure'):
        a, b = np.asarray(sol_f[k]), np.asarray(prof[k])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-6)


def test_fused_nan_column(tables):
    p, t, td = _grid(B=16)
    t = t.at[3].set(jnp.nan)
    td = td.at[7, 0].set(jnp.nan)
    res_f, _ = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    res_u, _ = cape.surface_based_cape_cin(p, t, td, tables=tables)
    np.testing.assert_allclose(np.asarray(res_f['cape']),
                               np.asarray(res_u['cape']), atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_f['cin']),
                               np.asarray(res_u['cin']), atol=1e-6)


def test_fused_padding_and_batch_shape(tables):
    # Non-multiple batch + multidimensional batch dims round-trip.
    p, t, td = _grid(B=70)
    p2 = p.reshape(7, 10, -1)
    t2 = t.reshape(7, 10, -1)
    td2 = td.reshape(7, 10, -1)
    res2, _ = fused.fused_surface_cape_cin(p2, t2, td2, tables=tables)
    res1, _ = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    np.testing.assert_allclose(np.asarray(res2['cape']).reshape(-1),
                               np.asarray(res1['cape']), atol=1e-6)


def test_fused_golden(tables):
    # The reference's golden surface-parcel sounding
    # (reference: modules/unit_tests.py:940-951): cape 230.20, cin -58.07.
    levels = jnp.array([[959., 779.2, 751.3, 724.3, 700., 269.]])
    temps = jnp.array([[22.2, 14.6, 12., 9.4, 7., -38.]]) + 273.15
    dews = jnp.array([[19., -11.2, -10.8, -10.4, -10., -53.2]]) + 273.15
    res, _ = fused.fused_surface_cape_cin(levels, temps, dews,
                                          tables=tables)
    assert abs(float(res['cape'][0]) - 230.20) < 0.5
    assert abs(float(res['cin'][0]) - (-58.07)) < 0.5


def test_fused_deep_columns(tables):
    # Deep columns (the reference's adiabat grid goes to 2196 levels) run
    # through the same program as 90-level ones.
    p, t, td = _grid(B=24, L=600)
    res_f, _ = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    res_u, _ = cape.surface_based_cape_cin(p, t, td, tables=tables)
    np.testing.assert_allclose(np.asarray(res_f['cape']),
                               np.asarray(res_u['cape']), atol=1e-5)


def test_fused_sharded_over_mesh(tables):
    # Production multi-device path: the fused solve under shard_map on the
    # 8-device CPU mesh (batch data-parallel, tables replicated).
    import jax
    from jax.sharding import PartitionSpec as P
    from xarray_parcel_tpu.parallel import make_mesh, replicate

    mesh = make_mesh(jax.devices('cpu')[:8])
    tab = replicate(tables, mesh)
    p, t, td = _grid(B=64)

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                       in_specs=(P('data'), P('data'), P('data')),
                       out_specs=(P('data'), P('data')))
    def run(p, t, td):
        res, _ = fused.fused_surface_cape_cin(p, t, td, tables=tab)
        return res['cape'], res['cin']

    cape_s, cin_s = run(p, t, td)
    res_u, _ = cape.surface_based_cape_cin(p, t, td, tables=tables)
    np.testing.assert_allclose(np.asarray(cape_s),
                               np.asarray(res_u['cape']), atol=1e-5)


def test_fused_gradients_match_modular(tables):
    """The fused solve is plain jnp under jit, so reverse mode runs
    through it directly: its gradient must match the modular path's
    (values and NaN patterns agree on a grid with a poisoned column)."""
    import jax

    p, t, td = _grid(B=40, L=44, seed=9)
    t = t.at[5].set(jnp.nan)                       # a poisoned column

    res_f, sol_f = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    res_u, sol_u = cape.surface_based_cape_cin(p, t, td, tables=tables)
    for k in ('cape', 'cin'):
        a, b = np.asarray(res_f[k]), np.asarray(res_u[k])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-6, err_msg=k)

    def total(fn):
        def f(t0):
            res, _ = fn(p, t.at[:, 0].set(t0), td, tables=tables)
            return jnp.nansum(res['cape'])
        return jax.grad(f)(t[:, 0])

    g_f = total(fused.fused_surface_cape_cin)
    g_u = total(cape.surface_based_cape_cin)
    assert np.isfinite(np.delete(np.asarray(g_f), 5)).all()
    np.testing.assert_allclose(np.asarray(g_f), np.asarray(g_u), atol=1e-5)


def test_fused_jaxpr_has_no_pallas_call(tables):
    # The fused solve is plain XLA on every backend: no Pallas kernel (and
    # so no interpreter fallback) anywhere in its program.
    import jax

    p, t, td = _grid(B=8, L=20)

    def solve(p, t, td):
        res, sol = fused.fused_surface_cape_cin(
            p, t, td, tables=tables, with_lifted_index=True,
            with_profile=True)
        return res, sol

    text = str(jax.make_jaxpr(solve)(p, t, td))
    assert 'name=_solve' in text            # the solve is in the program
    assert 'pallas_call' not in text


@pytest.mark.parametrize('B', [1, 7, 33])
def test_fused_li_and_profile_odd_batches(tables, B):
    """Lifted index and profile tracks at batch sizes with no power-of-two
    structure match the modular path's, with the spliced (L+1) shape."""
    from xarray_parcel_tpu import diagnostics as diag

    L = 30
    p, t, td = _grid(B=B, L=L, seed=B)
    res, _ = fused.fused_surface_cape_cin(
        p, t, td, tables=tables, with_lifted_index=True, with_profile=True)
    ref, prof = cape.surface_based_cape_cin(p, t, td, tables=tables)
    assert res['cape'].shape == (B,)
    for k in ('pressure', 'temperature', 'environment_temperature'):
        a = np.asarray(res['profile'][k])
        b = np.asarray(prof[k])
        assert a.shape == (B, L + 1) == b.shape, k
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-8, err_msg=k)
    li_ref = diag.lifted_index(prof)['lifted_index']
    np.testing.assert_allclose(np.asarray(res['lifted_index']),
                               np.asarray(li_ref), atol=1e-6)
    np.testing.assert_allclose(np.asarray(res['cape']),
                               np.asarray(ref['cape']), atol=1e-6)


def test_fused_out_of_envelope_parcel(tables):
    # A parcel outside the adiabat family's envelope (curve start
    # temperatures span ~173-316 K at 1100 hPa) has no moist track: the
    # blended coefficient row is NaN, no crossing exists, so LFC/EL are
    # NaN and cape/cin resolve to 0 by the missing-LFC rule — never
    # garbage — while in-envelope columns in the same batch are untouched.
    # Fused and XLA must agree exactly on all three regimes.
    p1 = jnp.array([959.0, 779.2, 751.3, 724.3, 700.0, 269.0])
    t1 = jnp.array([22.2, 14.6, 12.0, 9.4, 7.0, -38.0]) + 273.15
    td1 = jnp.array([19.0, -11.2, -10.8, -10.4, -10.0, -53.2]) + 273.15
    p = jnp.broadcast_to(p1, (3, 6))
    t = jnp.broadcast_to(t1, (3, 6))
    td = jnp.broadcast_to(td1, (3, 6))
    t = t.at[0, 0].set(400.0)               # far above the envelope
    td = td.at[0, 0].set(399.0)
    t = t.at[1, 0].set(150.0)               # far below it
    td = td.at[1, 0].set(149.0)
    res, sol = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    ref, _ = cape.surface_based_cape_cin(p, t, td, tables=tables)
    lfc = np.asarray(sol['lfc_pressure'])
    assert np.isnan(lfc[0]) and np.isnan(lfc[1]) and np.isfinite(lfc[2])
    for k in ('cape', 'cin'):
        got, want = np.asarray(res[k]), np.asarray(ref[k])
        assert got[0] == 0.0 and got[1] == 0.0, (k, got[:2])
        np.testing.assert_allclose(got, want, atol=1e-8, err_msg=k)
    assert abs(float(np.asarray(res['cape'])[2]) - 230.2) < 0.5


def test_fused_duplicate_pressure_levels(tables):
    # Exact duplicate pressure levels (zero-width gaps — the reference's
    # duplicate-aware interpolation case, parcel_functions.py:1758-1828)
    # must not produce divide-by-zero artifacts in the crossing solver;
    # a value-identical duplicate leaves the golden answer unchanged and
    # fused == XLA exactly either way.
    p1 = jnp.array([959.0, 779.2, 751.3, 751.3, 724.3, 700.0, 269.0])
    t1 = jnp.array([22.2, 14.6, 12.0, 12.0, 9.4, 7.0, -38.0]) + 273.15
    td1 = jnp.array([19.0, -11.2, -10.8, -10.8, -10.4, -10.0,
                     -53.2]) + 273.15
    for tt in (t1, t1.at[3].set(t1[3] + 0.5)):
        res_f, _ = fused.fused_surface_cape_cin(p1, tt, td1, tables=tables)
        res_x, _ = cape.surface_based_cape_cin(p1, tt, td1, tables=tables)
        for k in ('cape', 'cin'):
            a, b = float(res_f[k]), float(res_x[k])
            assert np.isfinite(a) and abs(a - b) < 1e-8, (k, a, b)
    res_f, _ = fused.fused_surface_cape_cin(p1, t1, td1, tables=tables)
    assert abs(float(res_f['cape']) - 230.2007) < 1e-3
    assert abs(float(res_f['cin']) - -58.0671) < 1e-3


def test_fused_batched_parcels_over_shared_column(tables):
    # A shared 1-D environment column with BATCHED parcel scalars is legal
    # in cape.cape_cin (the batch shape broadcasts from the parcels); the
    # fused drop-in must accept it identically.
    p, t, td = _grid(B=1)
    p1, t1, td1 = p[0], t[0], td[0]
    pt = jnp.asarray([float(t1[0]) + 0.5, float(t1[0]) + 1.5,
                      float(t1[0]) + 3.0])
    kw = dict(parcel_pressure=jnp.full((3,), p1[0]),
              parcel_temperature=pt,
              parcel_dewpoint=jnp.full((3,), td1[0]), tables=tables)
    res_f, _ = fused.fused_cape_cin(p1, t1, td1, **kw)
    res_u, _ = cape.cape_cin(p1, t1, td1, **kw)
    assert res_f['cape'].shape == (3,)
    np.testing.assert_allclose(np.asarray(res_f['cape']),
                               np.asarray(res_u['cape']), atol=1e-6)
    np.testing.assert_allclose(np.asarray(res_f['cin']),
                               np.asarray(res_u['cin']), atol=1e-6)
