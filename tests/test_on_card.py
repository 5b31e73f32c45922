"""Tests that need the card: the fused and modular paths as compiled for
the GPU, in fp64, against each other and against the regression archive.

They carry the ``gpu`` marker and skip (from the ``gpu`` fixture, at run
time) wherever JAX's first device is not a GPU.  Run them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_on_card.py

(``chip_smoke.py`` runs them as its last phase.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import adiabat, cape, fused, pipeline

from make_regression_archive import (assert_matches_archive, compute,
                                    load_archive, make_inputs)
from test_fused import _grid

pytestmark = pytest.mark.gpu


@pytest.fixture(scope='module')
def tables():
    return adiabat.load_moist_adiabat_lookups()


def test_fused_matches_modular_on_card(gpu, tables):
    p, t, td = (jax.device_put(x, gpu) for x in _grid(B=4096, L=90))
    res_f, sol_f = jax.jit(lambda p, t, td: fused.fused_surface_cape_cin(
        p, t, td, tables=tables))(p, t, td)
    res_u, prof = jax.jit(lambda p, t, td: cape.surface_based_cape_cin(
        p, t, td, tables=tables))(p, t, td)
    assert res_f['cape'].devices() == {gpu}
    for a, b in ((res_f['cape'], res_u['cape']), (res_f['cin'], res_u['cin']),
                 (sol_f['lfc_pressure'], prof['lfc_pressure'])):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-6)


def test_fused_pipeline_matches_modular_on_card(gpu, tables):
    dat = {k: jnp.asarray(v) for k, v in make_inputs().items()}
    fused_out = jax.jit(lambda d: pipeline.conv_properties_fused(
        d, tables=tables))(dat)
    ref = jax.jit(lambda d: pipeline.conv_properties(d, tables=tables))(dat)
    assert set(fused_out) == set(ref)
    for k in ref:
        a, b = np.asarray(fused_out[k]), np.asarray(ref[k])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   atol=1e-6, rtol=1e-9, err_msg=k)


def test_regression_archive_on_card(gpu):
    inputs, expect = load_archive()
    assert_matches_archive(compute(inputs), expect)
