"""Multi-host execution: 2 jax.distributed processes over a global mesh.

The reference actually runs its parallelism on a multi-worker dask
LocalCluster (reference: parcel_functions_demo.ipynb cell 3); the
JAX analogue is ``jax.distributed`` processes joined into one
global device mesh.  This test spawns a coordinator and a
second process (4 virtual CPU devices each → an 8-device global mesh
spanning both), runs the full sharded pipeline through
``parallel.distributed_init`` + ``make_mesh`` + ``shard_batch``, and
checks every process's addressable output shards against a
single-process reference — plus the psum/pmax validation collective
across the process boundary (gloo here; ICI/DCN on real hardware).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _make_grid(B=24, L=40, seed=11):
    rng = np.random.default_rng(seed)
    p = np.linspace(1008.0, 180.0, L)
    p = -np.sort(-(np.broadcast_to(p, (B, L)) +
                   rng.normal(0, 0.3, (B, L))), axis=-1)
    t = 301.0 - 72.0 * (1.0 - (p / 1008.0) ** 0.3) + rng.normal(0, 1, (B, L))
    td = t - (np.abs(rng.normal(2, 2, (B, L))) + 0.3 +
              14.0 * (1.0 - p / 1008.0) ** 2)
    td = np.minimum(td, t - 0.2)
    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    eps = 0.6219569100577033
    w = eps * e / (p - e)
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    t[3, 7] = np.nan          # one poisoned level: NaN semantics cross hosts
    return {
        'pressure': p, 'temperature': t, 'specific_humidity': w / (1.0 + w),
        'height_asl': h,
        'surface_wind_u': rng.normal(3, 2, (B,)),
        'surface_wind_v': rng.normal(0, 2, (B,)),
        'wind_u': rng.normal(8, 5, (B, L)),
        'wind_v': rng.normal(2, 5, (B, L)),
        'wind_height_above_surface': h - h[..., :1],
    }


def test_two_process_global_mesh(tmp_path):
    import jax
    from xarray_parcel_tpu import adiabat, pipeline

    # Single-process reference, computed here (the parent). Also warms the
    # fp64 table cache so the two workers never race to build it.
    dat = _make_grid()
    tables = adiabat.load_moist_adiabat_lookups()
    ref = jax.jit(lambda d: pipeline.conv_properties(d, tables=tables))(
        {k: np.asarray(v) for k, v in dat.items()})
    ref = {k: np.asarray(jax.device_get(v)) for k, v in ref.items()}
    assert np.isfinite(ref['mu_cape']).any()
    # Reference for the workers' SPMD serving check (deploy artifact of
    # the reduced pipeline, served on a non-divisible batch).
    minref = jax.jit(lambda d: pipeline.min_conv_properties(
        d, tables=tables))({k: np.asarray(v) for k, v in dat.items()})
    minref = {k: np.asarray(jax.device_get(v)) for k, v in minref.items()}

    path = tmp_path / 'grid.npz'
    np.savez(path, **{f'in_{k}': v for k, v in dat.items()},
             **{f'out_{k}': v for k, v in ref.items()},
             **{f'minout_{k}': v for k, v in minref.items()})

    port = _free_port()
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)   # workers force cpu via jax.config
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, 'distributed_worker.py'),
             str(i), '2', str(port), str(path)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=480)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {i} failed:\n{out}'
        assert f'[worker {i}] OK' in out, out
        assert '8 global devices' in out, out
        assert f'[worker {i}] serving OK' in out, out
