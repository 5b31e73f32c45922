"""Device-resident chunked execution inside ONE compiled program.

``stream_map`` (the out-of-core path) streams host chunks through repeated
dispatches; this module is its on-device complement: the whole batch is
already resident, but the program runs it chunk-by-chunk under ``lax.map``
so (a) XLA's scheduler only ever sees chunk-sized intermediates — a
batch whose whole-batch intermediates would not fit device memory runs in
chunk-sized memory instead — and (b) the entire batch costs ONE dispatch,
so any fixed per-dispatch overhead amortises over the full batch rather
than per chunk.

The reference's analogue is dask graph fusion over chunks (reference:
modules/parcel_functions.py:561-579 re-chunks and persists inside one lazy
graph); the JAX form is a ``lax.map`` whose body is the column
program — same numerics as calling the program per chunk, sequenced by the
compiler instead of a task scheduler.

Composition: for multi-device runs, wrap the *sharded* program —
``chunked`` reshapes only the leading batch dim, so under ``shard_map``
each device scans over its own shard's chunks.
"""

import numpy as np

import jax
import jax.numpy as jnp


def pad_fill(dtype, float_fill=np.nan):
    """The batch-padding value contract, shared with ``deploy.Deployed``
    and ``parallel.pad_batch``: ``float_fill`` (NaN — the pipelines' NaN
    semantics turn padded rows into NaN outputs) for floats, zero for
    ints/bools.  Padded rows are sliced off."""
    dtype = np.dtype(dtype)
    return (float_fill if np.issubdtype(dtype, np.floating)
            else np.zeros((), dtype))


def chunked(fn, chunk_columns=1 << 18):
    """Wrap a dict->pytree column program so it executes in fixed-size
    column chunks under ``lax.map`` — one compiled program, chunk-bounded
    working set, any batch size.

    ``fn`` takes a dict of arrays with a shared leading batch dim (level
    fields (B, L), surface fields (B,)) and returns a pytree of arrays
    with the same leading dim.  The wrapper pads B up to a multiple of
    ``chunk_columns`` (NaN for floats, zero for ints/bools — padded rows
    are sliced off the outputs), reshapes to (n_chunks, chunk, ...), maps
    ``fn`` over chunks, and restores the original batch dim.

    Numerics are identical to running ``fn`` on each padded chunk and
    concatenating (pinned by tests); against a single whole-batch call the
    usual fp32 batch-shape compile wobble applies (docs/performance.md).
    """
    def wrapped(dat):
        leaves = jax.tree_util.tree_leaves(dat)
        if not leaves:
            raise ValueError('empty input pytree — nothing to chunk')
        if any(not np.shape(x) for x in leaves):
            raise ValueError('inputs must carry a leading batch dim; '
                             'got a 0-d leaf')
        sizes = {np.shape(x)[0] for x in leaves}
        if len(sizes) != 1:
            raise ValueError(f'mixed leading batch dims: {sorted(sizes)}')
        B = sizes.pop()
        C = max(1, min(int(chunk_columns), B))
        pad = (-B) % C
        n = (B + pad) // C

        def stack(x):
            x = jnp.asarray(x)
            if pad:
                x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                            constant_values=pad_fill(x.dtype))
            return x.reshape((n, C) + x.shape[1:])

        out = jax.lax.map(fn, jax.tree_util.tree_map(stack, dat))

        def unstack(y):
            y = y.reshape((n * C,) + y.shape[2:])
            return y[:B] if pad else y

        return jax.tree_util.tree_map(unstack, out)

    return wrapped


_SCAN_MAP_JITS = {}


def scan_map(fn, dat, chunk_columns=1 << 18, jit=True):
    """One-shot form: run ``fn`` over ``dat`` chunk-wise in one program.

    Convenience for ``jax.jit(chunked(fn, chunk_columns))(dat)``; pass
    ``jit=False`` to trace inside an enclosing jit instead.  The jitted
    wrapper is memoized per ``(fn, chunk_columns)`` so calling scan_map
    in a loop reuses one traced program instead of re-tracing each call
    (JAX's executable cache is keyed on function identity).
    """
    if not jit:
        return chunked(fn, chunk_columns)(dat)
    key = (fn, int(chunk_columns))
    wrapped = _SCAN_MAP_JITS.get(key)
    if wrapped is None:
        wrapped = _SCAN_MAP_JITS.setdefault(
            key, jax.jit(chunked(fn, chunk_columns)))
    return wrapped(dat)
