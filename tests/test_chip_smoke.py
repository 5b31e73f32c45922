"""chip_smoke.py's pieces that run without a card: the device check, the
nvidia-smi parser, and the comparators its phases assert with."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from xarray_parcel_tpu import adiabat, pipeline  # noqa: E402
from xarray_parcel_tpu.utils import device  # noqa: E402

from make_regression_archive import make_inputs  # noqa: E402


def test_check_device_raises_without_gpu():
    assert jax.devices()[0].platform == 'cpu'
    with pytest.raises(RuntimeError, match='no GPU'):
        chip_smoke.check_device()


def test_script_refuses_cpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert 'no GPU' in proc.stderr
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize('text, want', [
    ('NVIDIA H100 80GB HBM3, 700.00 W\n',
     [('NVIDIA H100 80GB HBM3', '700.00 W')]),
    ('NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n\n',
     [('NVIDIA H100 80GB HBM3', '700.00 W'),
      ('NVIDIA H100 80GB HBM3', '500.00 W')]),
    ('', []),
])
def test_parse_nvidia_smi(text, want):
    assert device.parse_nvidia_smi(text) == want


@pytest.mark.parametrize('bad', ['NVIDIA H100 80GB HBM3', ', 700.00 W',
                                 'NVIDIA H100,'])
def test_parse_nvidia_smi_rejects_malformed(bad):
    with pytest.raises(ValueError):
        device.parse_nvidia_smi(bad)


def test_fp32_envelope_on_tiny_grid():
    """fp32 against fp64 on test_fp32_budget's tiny grid is within its
    bounds; a corrupted variable is reported by name."""
    inputs = make_inputs()
    tables64 = adiabat.load_moist_adiabat_lookups()

    def run(tab, dtype):
        dat = {k: jnp.asarray(v, dtype) for k, v in inputs.items()}
        out = jax.jit(lambda d, t: pipeline.min_conv_properties_fused(
            d, tables=t))(dat, tab)
        return {k: np.asarray(v) for k, v in out.items()}

    ref = run(tables64, jnp.float64)
    got = run(tables64.astype(jnp.float32), jnp.float32)
    env = chip_smoke.fp32_envelope(ref, got)
    assert set(env) == set(ref)
    assert chip_smoke.budget_violations(env) == []
    p95, name = chip_smoke.worst(env)['p95']
    assert p95 <= 1e-4 and name in ref

    got['mixed_100_cape'] = got['mixed_100_cape'] * 1.01
    got['mixed_100_cin'] = np.full_like(got['mixed_100_cin'], np.nan)
    bad = chip_smoke.budget_violations(chip_smoke.fp32_envelope(ref, got))
    assert any(v.startswith('mixed_100_cape: p95') for v in bad), bad
    assert any(v.startswith('mixed_100_cin: nan_flips') for v in bad), bad


def test_assert_agree_counts_mismatches():
    rng = np.random.default_rng(0)
    ref = {'cape': rng.uniform(0, 3000, 1000), 'flag': rng.random(1000) > .5}
    ref['cape'][:3] = np.nan
    same = {k: v.copy() for k, v in ref.items()}
    chip_smoke.assert_agree('identical', ref, same)
    mm = chip_smoke.mismatch(ref, same)
    assert mm == {'cape': (0.0, 0.0), 'flag': (0.0, 0.0)}

    off = {k: v.copy() for k, v in ref.items()}
    off['cape'][10] += 5.0
    off['flag'][20] = ~off['flag'][20]
    mm = chip_smoke.mismatch(ref, off)
    assert mm['cape'] == (1e-3, pytest.approx(5.0))
    assert mm['flag'][0] == 1e-3
    with pytest.raises(AssertionError, match='mismatch share'):
        chip_smoke.assert_agree('off by one column', ref, off)
    chip_smoke.assert_agree('within limit', ref, off, limit=1e-3)
