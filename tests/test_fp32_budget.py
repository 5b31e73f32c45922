"""fp32 error budget: the production dtype vs the fp64 reference path.

Production runs in fp32 for throughput at bounded relative error
(BASELINE.md's accuracy row), so this test pins the fp32 error envelope of
the full CAPE solve against the fp64 path on the same convective grid used
by the serial-oracle integration tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import adiabat, cape, fused

from test_integration_serial import make_grid


@pytest.fixture(scope='module')
def tables64():
    return adiabat.load_moist_adiabat_lookups()


@pytest.fixture(scope='module')
def grid():
    return make_grid()


def _cape(p, t, td, tables, fn):
    res, _ = jax.jit(lambda p, t, td: fn(p, t, td, tables=tables))(p, t, td)
    return np.asarray(res['cape'], np.float64), np.asarray(res['cin'],
                                                           np.float64)


def test_fp32_cape_budget(tables64, grid):
    p, t, td = (jnp.asarray(v) for v in grid)
    cape64, cin64 = _cape(p, t, td, tables64, cape.surface_based_cape_cin)

    tables32 = tables64.astype(jnp.float32)
    p32, t32, td32 = (jnp.asarray(v, jnp.float32) for v in grid)
    assert p32.dtype == jnp.float32

    for name, fn in (('xla', cape.surface_based_cape_cin),
                     ('fused', fused.fused_surface_cape_cin)):
        cape32, cin32 = _cape(p32, t32, td32, tables32, fn)
        assert cape32.dtype == np.float64 and not np.isnan(cape32).all()
        for q, a64, a32 in (('cape', cape64, cape32), ('cin', cin64, cin32)):
            d = np.abs(a32 - a64)
            # Branch flips (LFC/EL selection moving a level under fp32) are
            # legitimate for near-degenerate columns; bound the bulk error
            # and the flip rate rather than the worst case.
            bulk = np.nanquantile(d, 0.95)
            flips = np.mean(d > 5.0)
            assert bulk < 1.0, f'{name}/{q}: p95 fp32 error {bulk:.3f} J/kg'
            assert flips < 0.05, f'{name}/{q}: {flips:.1%} branch flips'


def test_fp32_full_pipeline_budget(tables64):
    """fp32 envelope of EVERY conv_properties_fused output (the production
    deployment runs the full ~20-variable pipeline in fp32) plus the storm
    proxies, against the fp64 run on the archive's convective grid.

    Bounds pin the BASELINE.md accuracy row (rel-err <= 1e-4 at p95 of
    the variable's own scale); measured values on this grid are recorded
    in docs/performance.md (worst p95 4.7e-5, worst max 9.1e-5 — both on
    mixed_50_cape — zero NaN-pattern flips, zero proxy flips).
    """
    import sys
    import os
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from make_regression_archive import make_inputs
    from xarray_parcel_tpu import pipeline

    inputs = make_inputs()

    def run(dat, tables):
        out = pipeline.conv_properties_fused(dat, tables=tables)
        out.update(pipeline.storm_proxies(out))
        return out

    dat64 = {k: jnp.asarray(v) for k, v in inputs.items()}
    out64 = jax.jit(lambda d: run(d, tables64))(dat64)
    out64 = {k: np.asarray(v) for k, v in out64.items()}

    tables32 = tables64.astype(jnp.float32)
    dat32 = {k: jnp.asarray(v, jnp.float32) for k, v in inputs.items()}
    out32 = jax.jit(lambda d: run(d, tables32))(dat32)
    out32 = {k: np.asarray(v) for k, v in out32.items()}

    assert set(out64) == set(out32) and len(out64) > 20
    for k in sorted(out64):
        a, b = out64[k], out32[k]
        if a.dtype == bool:
            # Thresholded proxies: flips need a threshold variable to sit
            # within its fp32 envelope of the cut — rare by construction.
            flips = np.mean(a != b.astype(bool))
            assert flips <= 0.05, f'{k}: {flips:.1%} proxy flips'
            continue
        b = b.astype(np.float64)
        nanflips = np.mean(np.isnan(a) != np.isnan(b))
        assert nanflips <= 0.01, f'{k}: {nanflips:.1%} NaN-pattern flips'
        both = ~np.isnan(a) & ~np.isnan(b)
        if not both.any():
            continue
        scale = max(1.0, float(np.nanmax(np.abs(a))))
        d = np.abs(a[both] - b[both]) / scale
        p95 = float(np.quantile(d, 0.95))
        assert p95 <= 1e-4, f'{k}: p95 rel err {p95:.2e} > 1e-4'
        assert float(d.max()) <= 5e-4, f'{k}: max rel err {d.max():.2e}'
