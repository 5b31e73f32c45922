"""Out-of-core streaming execution over column chunks.

The reference handles grids larger than memory by dask chunking (lazy graphs
over lat/lon chunks, reference: its notebooks' ``chunks=10`` /
``.chunk({'latitude': 50, ...})``).  The JAX analogue: stream fixed-size
column chunks through one compiled program — host->device transfer of chunk
k+1 overlaps compute of chunk k via JAX's async dispatch, and only results
are pulled back.  One compiled shape (the last chunk is NaN-padded), so
there is exactly one compile.
"""

import numpy as np

import jax
import jax.numpy as jnp


def _batch_shape(dat, level_vars):
    for k in level_vars:
        if k in dat:
            return np.shape(dat[k])[:-1]
    raise ValueError('no level variable found to infer the batch shape')


def stream_map(fn, dat, batch_columns=1 << 16,
               level_vars=('pressure', 'temperature', 'dewpoint',
                           'specific_humidity'), jit=True, mesh=None,
               prefetch=2):
    """Run ``fn`` (a dict->dict column program, e.g.
    ``pipeline.conv_properties``) over ``dat`` in column chunks.

    ``dat``: dict of host arrays, batch dims leading ((…, L) level fields or
    (…) surface fields).  Returns a dict of host numpy arrays with the full
    batch shape.  ``fn`` is jitted once; chunks are NaN-padded to one static
    shape, and transfers overlap compute through async dispatch.
    ``jit=False`` when ``fn`` already wraps a jitted callable (avoids
    re-tracing a fresh outer jit per stream_map call).

    ``mesh``: shard every chunk's batch dim over the mesh
    (``parallel.shard_batch``), so grids larger than one device's HBM
    stream through ALL devices SPMD — the out-of-core and the
    data-parallel paths compose.  The chunk size rounds up to a multiple
    of the mesh size (XLA sharding needs divisibility; padded columns are
    NaN and sliced off as usual).

    ``prefetch``: how many chunks may be resident on device beyond the one
    being read back (default 2 — classic double buffering).  Result
    readback runs on a background thread, so the device->host copy
    overlaps the next chunks' dispatch instead of serialising against it;
    device memory stays bounded at ``prefetch + 1`` chunks of outputs.
    """
    batch = _batch_shape(dat, level_vars)
    B = int(np.prod(batch)) if batch else 1

    flat = {}
    for k, v in dat.items():
        v = np.asarray(v)
        trail = v.shape[len(batch):]
        flat[k] = v.reshape((B,) + trail)

    jfn = jax.jit(fn) if jit else fn
    n_chunk = max(1, min(batch_columns, B))
    if mesh is not None:
        from .mesh import shard_batch
        n_dev = mesh.devices.size
        n_chunk += (-n_chunk) % n_dev                 # round up to divisible
        place = lambda chunk: shard_batch(chunk, mesh)
    else:
        place = lambda chunk: {k: jnp.asarray(v) for k, v in chunk.items()}
    if B == 0:
        # Empty batch: run one NaN chunk for the output structure, keep 0.
        n0 = mesh.devices.size if mesh is not None else 1
        chunk = {k: jnp.full((n0,) + v.shape[1:], jnp.nan, v.dtype)
                 if np.issubdtype(v.dtype, np.floating)
                 else jnp.zeros((n0,) + v.shape[1:], v.dtype)
                 for k, v in flat.items()}
        out = jfn(place(chunk))
        return {k: np.asarray(v)[:0].reshape(batch + np.shape(v)[1:])
                for k, v in out.items()}

    def readback(n, out):
        return {k: np.asarray(jax.device_get(v))[:n] for k, v in out.items()}

    from concurrent.futures import ThreadPoolExecutor
    results = []
    futures = []                      # ordered in-flight readbacks
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        for start in range(0, B, n_chunk):
            stop = min(start + n_chunk, B)
            pad = n_chunk - (stop - start)
            chunk = {}
            for k, v in flat.items():
                c = v[start:stop]
                if pad:
                    # NaN-pad floats; integer/bool fields (ids, flags) have
                    # no NaN and the padded rows are sliced off regardless
                    # (same rule as parallel.pad_batch).
                    value = (np.nan if np.issubdtype(c.dtype, np.floating)
                             else np.zeros((), c.dtype))
                    c = np.pad(c, ((0, pad),) + ((0, 0),) * (c.ndim - 1),
                               constant_values=value)
                chunk[k] = c
            # Dispatch compute, hand the readback to the background thread
            # immediately (it blocks there until the chunk completes), and
            # keep dispatching — bounded by `prefetch` chunks resident
            # beyond the one being read back.
            futures.append(pool.submit(readback, stop - start,
                                       jfn(place(chunk))))
            while len(futures) > max(1, prefetch):
                results.append(futures.pop(0).result())
        for f in futures:
            results.append(f.result())
    finally:
        pool.shutdown(wait=True)

    merged = {}
    for k in results[0]:
        arr = np.concatenate([r[k] for r in results], axis=0)
        merged[k] = arr.reshape(batch + arr.shape[1:])
    return merged
