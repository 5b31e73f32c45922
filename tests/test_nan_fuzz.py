"""Adversarial NaN-pattern fuzz: fused column program vs modular XLA path.

The reference's NaN contract (NaN = missing, preserved through every op)
must hold identically on both execution paths for arbitrary NaN patterns:
leading-NaN padding, interior poisoned levels, all-NaN columns, NaN parcel
states.  Any divergence is a semantics fork between the fused solve and
the library — exactly the bug class this suite exists to catch.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import adiabat, cape, fused


@pytest.fixture(scope='module')
def tables():
    return adiabat.load_moist_adiabat_lookups()


def _fuzz_grid(seed, B=64, L=32):
    rng = np.random.default_rng(seed)
    p = np.linspace(1008.0, 200.0, L)
    p = np.broadcast_to(p, (B, L)) + rng.normal(0, 0.3, (B, L))
    p = -np.sort(-p, axis=-1)
    t = 301.0 - 72.0 * (1.0 - (p / 1008.0) ** 0.3) + rng.normal(
        0, 2, (B, L))
    td = t - np.abs(rng.normal(4, 4, (B, L))) - 0.2

    # Adversarial NaN injection.
    for i in range(B):
        mode = i % 6
        if mode == 1:            # top padding (the compact-left shape)
            n = rng.integers(1, L // 2)
            p[i, L - n:] = np.nan
            t[i, L - n:] = np.nan
            td[i, L - n:] = np.nan
        elif mode == 2:          # interior poisoned temperature levels
            idx = rng.choice(L, rng.integers(1, 5), replace=False)
            t[i, idx] = np.nan
        elif mode == 3:          # interior poisoned dewpoints
            idx = rng.choice(L, rng.integers(1, 5), replace=False)
            td[i, idx] = np.nan
        elif mode == 4:          # all-NaN column
            p[i] = t[i] = td[i] = np.nan
        elif mode == 5:          # NaN parcel state (surface level)
            t[i, 0] = np.nan
    return jnp.asarray(p), jnp.asarray(t), jnp.asarray(td)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_fused_matches_xla_under_nan_fuzz(tables, seed):
    p, t, td = _fuzz_grid(seed)
    res_f, sol_f = fused.fused_surface_cape_cin(p, t, td, tables=tables)
    res_u, prof = cape.surface_based_cape_cin(p, t, td, tables=tables)
    for k in ('cape', 'cin'):
        a, b = np.asarray(res_f[k]), np.asarray(res_u[k])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                      err_msg=f'NaN pattern: {k} seed={seed}')
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-6, err_msg=f'{k} seed={seed}')
    for k in ('lfc_pressure', 'el_pressure'):
        a, b = np.asarray(sol_f[k]), np.asarray(prof[k])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                      err_msg=f'NaN pattern: {k} seed={seed}')
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-6, err_msg=f'{k} seed={seed}')


def test_all_nan_grid(tables):
    p = jnp.full((8, 16), jnp.nan)
    res_f, _ = fused.fused_surface_cape_cin(p, p, p, tables=tables)
    res_u, _ = cape.surface_based_cape_cin(p, p, p, tables=tables)
    for k in ('cape', 'cin'):
        # All-NaN input -> CAPE/CIN 0 on both paths (no LFC exists).
        np.testing.assert_array_equal(np.asarray(res_f[k]),
                                      np.asarray(res_u[k]))
