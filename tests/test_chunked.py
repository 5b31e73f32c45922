"""Device-resident chunked execution (parallel.chunked / scan_map).

Pins that lax.map-chunked execution is numerically identical to running the
program per chunk and concatenating — the execution strategy that lets one
dispatch carry batches whose whole-batch compile would blow XLA's scheduler
(the JAX analogue of the reference's dask graph fusion over chunks,
reference: modules/parcel_functions.py:561-579)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from xarray_parcel_tpu import adiabat, pipeline
from xarray_parcel_tpu.parallel import chunked, scan_map


@pytest.fixture(scope='module')
def tables():
    return adiabat.load_moist_adiabat_lookups()


def _toy(dat):
    # A shape-exercising column program: level reduction, surface passthrough,
    # a bool output and an int output.
    s = jnp.nansum(dat['pressure'] * dat['temperature'], axis=-1)
    return {'s': s + dat['surface'],
            'flag': s > 0,
            'count': jnp.sum(jnp.asarray(~jnp.isnan(dat['pressure']),
                                         jnp.int32), axis=-1)}


def _toy_dat(B, L=7, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(100.0, 1000.0, (B, L))
    p[rng.random((B, L)) < 0.1] = np.nan
    return {'pressure': jnp.asarray(p),
            'temperature': jnp.asarray(rng.normal(260.0, 20.0, (B, L))),
            'surface': jnp.asarray(rng.normal(0.0, 1.0, (B,))),
            'ids': jnp.asarray(rng.integers(0, 9, (B,)), jnp.int32)}


def _per_chunk_reference(fn, dat, C):
    """fn applied per padded chunk, concatenated — the exactness oracle."""
    B = np.shape(jax.tree_util.tree_leaves(dat)[0])[0]
    outs = []
    for start in range(0, B, C):
        stop = min(start + C, B)
        pad = C - (stop - start)

        def cut(x):
            c = np.asarray(x)[start:stop]
            if pad:
                value = (np.nan if np.issubdtype(c.dtype, np.floating)
                         else np.zeros((), c.dtype))
                c = np.pad(c, [(0, pad)] + [(0, 0)] * (c.ndim - 1),
                           constant_values=value)
            return jnp.asarray(c)

        out = fn(jax.tree_util.tree_map(cut, dat))
        outs.append(jax.tree_util.tree_map(
            lambda y: np.asarray(y)[:stop - start], out))
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


@pytest.mark.parametrize('B,C', [(24, 8), (23, 8), (5, 8), (8, 8), (17, 4)])
def test_chunked_equals_per_chunk(B, C):
    dat = _toy_dat(B)
    want = _per_chunk_reference(_toy, dat, min(C, B))
    got = scan_map(_toy, dat, chunk_columns=C)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)
        assert np.asarray(got[k]).shape[0] == B


def test_chunked_inside_jit():
    dat = _toy_dat(19, seed=3)
    fn = jax.jit(chunked(_toy, chunk_columns=4))
    got = fn(dat)
    want = _per_chunk_reference(_toy, dat, 4)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)


def test_chunked_mixed_batch_dims_raises():
    dat = _toy_dat(8)
    dat['surface'] = dat['surface'][:4]
    with pytest.raises(ValueError, match='mixed leading batch dims'):
        chunked(_toy)(dat)


def test_chunked_composes_with_mesh_sharding():
    """The documented composition (chunked.py module docstring): wrap the
    *sharded* program, so each device scans over its own shard's chunks —
    chunk sizing then applies per shard, and results still match the
    unsharded whole-batch run exactly."""
    import functools

    from jax.sharding import PartitionSpec as P

    from xarray_parcel_tpu.parallel import make_mesh, shard_batch

    mesh = make_mesh(jax.devices()[:8])
    B = 48                                  # 6 columns per device
    dat = _toy_dat(B, seed=7)

    @jax.jit
    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=({k: P('data') for k in dat},),
        out_specs={'s': P('data'), 'flag': P('data'), 'count': P('data')})
    def sharded_chunked(d):
        return chunked(_toy, chunk_columns=2)(d)   # 3 chunks per shard

    got = sharded_chunked(shard_batch(dat, mesh))
    want = _per_chunk_reference(_toy, dat, 2)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)


def test_chunked_pipeline_matches_whole(tables):
    """The production program under chunking: the fused pipeline, chunked
    vs per-chunk exact and vs whole-batch within fp64 tolerance."""
    rng = np.random.default_rng(5)
    B, L = 12, 20
    p = np.linspace(1005.0, 250.0, L)
    p = np.broadcast_to(p, (B, L)) + rng.normal(0, 0.2, (B, L))
    p = -np.sort(-p, axis=-1)
    t = 300.0 - 65.0 * (1.0 - (p / 1005.0) ** 0.29) + rng.normal(0, 2,
                                                                 (B, L))
    td = t - (np.abs(rng.normal(3, 2, (B, L))) + 0.3)
    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = 0.6219569100577033 * e / (p - e)
    q = w / (1.0 + w)
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    dat = {k: jnp.asarray(v) for k, v in {
        'pressure': p, 'temperature': t, 'specific_humidity': q,
        'height_asl': h,
        'surface_wind_u': rng.normal(3, 2, (B,)),
        'surface_wind_v': rng.normal(0, 2, (B,)),
        'wind_u': rng.normal(8, 5, (B, L)),
        'wind_v': rng.normal(2, 5, (B, L)),
        'wind_height_above_surface': h - h[..., :1],
    }.items()}

    fn = lambda d: pipeline.conv_properties_fused(d, tables=tables)
    got = scan_map(fn, dat, chunk_columns=5)     # non-divisible: 12 = 2*5+2
    want_chunks = _per_chunk_reference(fn, dat, 5)
    whole = fn(dat)
    for k in whole:
        a = np.asarray(got[k])
        # The scan body may fuse differently than a standalone dispatch of
        # the same chunk program — identical NaN/bool semantics, values to
        # ulp-level (measured 2.5e-13 max rel in fp64).
        np.testing.assert_array_equal(np.isnan(a),
                                      np.isnan(want_chunks[k]), err_msg=k)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, want_chunks[k], err_msg=k)
        else:
            np.testing.assert_allclose(a, want_chunks[k], rtol=1e-11,
                                       atol=1e-11, err_msg=k)
        b = np.asarray(whole[k])
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9,
                                       err_msg=k)
