"""Test configuration: fp64 CPU JAX with an 8-device virtual mesh.

The reference's golden tolerances (2-7 decimals, MetPy-derived) need fp64,
so correctness tests run with x64 enabled on the CPU backend unless
``JAX_PLATFORMS`` names another (``JAX_PLATFORMS=cuda`` runs the
``gpu``-marked tests on the card); multi-device sharding tests use
xla_force_host_platform_device_count=8 (something the reference,
dask-bound, never had).
"""

import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
flags = os.environ.get('XLA_FLAGS', '')
if 'host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8').strip()

import jax
import pytest

jax.config.update('jax_enable_x64', True)

# Persistent compilation cache: the expensive whole-pipeline compiles
# repeat identically across suite runs.  Entries under 2 s stay uncached
# to keep lookup/write overhead below the win.
from xarray_parcel_tpu import deploy

deploy.enable_compilation_cache(min_compile_time_secs=2.0)


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise.

    Tests that need the card take this fixture and carry the ``gpu``
    marker; the decision is made here, at run time, never at import."""
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        pytest.skip(f'needs a GPU; JAX device 0 is {dev.platform}')
    return dev
