"""Device-mesh data parallelism over grid columns.

The reference's only parallelism is dask chunk parallelism over lat/lon/time
(reference: modules/parcel_functions.py:561-592, :667 and the LocalCluster
setup in its notebooks).  The JAX mapping: columns are independent, so
batch axes shard over a ``jax.sharding.Mesh`` (the cards of a host, or
hosts joined by ``jax.distributed``) while the level axis stays whole on
each device; XLA inserts no collectives
in the pipeline itself — communication appears only in explicit global
reductions (validation statistics), done with ``psum``/``pmax`` under
``shard_map``.

The adiabat tables are replicated on every device (they are read-only,
~130 MB fp32 — cheap against HBM) so every column's gathers stay local.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def distributed_init(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Multi-host initialisation for multi-process runs.

    Thin wrapper over ``jax.distributed.initialize`` (auto-detecting under
    cluster launchers that export the coordinator) — the launch-side
    counterpart of the reference's dask LocalCluster/Client setup (its
    notebooks' cell 3).
    Call once per host before ``make_mesh()``; afterwards ``jax.devices()``
    spans every process's devices and batch sharding is transparent.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(devices=None, axis_names=('data',), shape=None):
    """Build a mesh over ``devices`` (default: all) with the given axis
    names; ``shape`` defaults to all devices on the first axis."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    arr = np.array(devices).reshape(shape)
    return Mesh(arr, axis_names)


def replicated(mesh):
    return NamedSharding(mesh, P())


def _put_global(x, sharding):
    """device_put that works under multi-process (multi-host) meshes.

    Multi-process ``jax.device_put`` verifies the value is identical on
    every process with an elementwise comparison — which a NaN anywhere
    (NaN-padded grids, the lookup tables' invalid regions) fails by
    definition.  ``make_array_from_callback`` is the real multi-host
    ingest: each process materialises only its addressable shards, no
    consistency broadcast.  Single-process keeps the direct device_put
    (host numpy transfers straight to each shard's device).
    """
    if jax.process_count() > 1:
        x = np.asarray(x)
        dt = jax.dtypes.canonicalize_dtype(x.dtype)   # match device_put
        if x.dtype != dt:
            x = x.astype(dt)
        return jax.make_array_from_callback(x.shape, sharding,
                                            lambda idx: x[idx])
    return jax.device_put(x, sharding)


def batch_spec(mesh, ndim, batch_dims=1):
    """PartitionSpec sharding the leading ``batch_dims`` dims over the mesh
    axes (one mesh axis per batch dim, in order), rest replicated."""
    names = list(mesh.axis_names[:batch_dims])
    spec = names + [None] * (ndim - len(names))
    return P(*spec)


def shard_batch(tree, mesh, batch_dims=1):
    """device_put every array in a pytree with its leading batch dims sharded
    over the mesh (the xarray->device ingest boundary).

    Every leaf must carry the full leading batch prefix: a surface field
    (B,) shards its only dim, a level field (B, L) its first.  (A shared
    level-only vector (L,) would be indistinguishable from a surface field
    by shape — broadcast such fields to the batch before ingest.)
    """
    def put(x):
        if not hasattr(x, 'ndim'):
            x = np.asarray(x)
        # device_put straight from host numpy: each shard transfers to its
        # own device (dtypes canonicalize the same as jnp.asarray would).
        # A jnp.asarray first would stage the WHOLE array on the default
        # device and then reshard — double placement.
        bd = min(batch_dims, x.ndim)
        return _put_global(x, NamedSharding(mesh, batch_spec(mesh, x.ndim,
                                                             bd)))
    return jax.tree_util.tree_map(put, tree)


def pad_batch(tree, mesh, fill=np.nan):
    """Pad every array's leading dim to a multiple of the mesh size.

    XLA shardings require the sharded dim to divide evenly; real grids
    rarely do.  Columns are independent and every op is NaN-transparent, so
    the production recipe is pad -> shard -> compute -> slice.  Float
    leaves pad with ``fill`` (NaN); integer/bool leaves (station ids,
    flags) pad with zero, since NaN has no representation there and the
    padded rows are sliced off regardless.  Returns
    ``(padded_tree, original_batch)``; slice outputs with ``[:original]``.
    """
    n = mesh.devices.size
    leaves = jax.tree_util.tree_leaves(tree)
    if not leaves:
        raise ValueError('empty pytree — nothing to pad')
    sizes = {np.asarray(x).shape[0] for x in leaves}
    if len(sizes) != 1:
        raise ValueError(f'mixed leading-dim sizes: {sorted(sizes)}')
    b = sizes.pop()
    pad = (-b) % n

    from .chunked import pad_fill

    def one(x):
        x = np.asarray(x)
        if not pad:
            return x
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths,
                      constant_values=pad_fill(x.dtype, float_fill=fill))

    return jax.tree_util.tree_map(one, tree), b


def replicate(tree, mesh):
    """device_put a pytree fully replicated (for the adiabat tables)."""
    return jax.tree_util.tree_map(
        lambda x: _put_global(x, replicated(mesh)), tree)


def sharded_jit(fn, mesh, batch_dims=1, donate=False):
    """jit ``fn`` so array args/outputs with >= batch_dims+1 dims shard their
    leading batch dims over the mesh.  The closest analogue of the
    reference's "open chunked + compute" pattern, compiled once.

    ``donate=True`` donates every positional argument's buffer to the
    computation (outputs may reuse input HBM — the difference between
    fitting and OOMing at the largest batches)."""
    jits = {}                       # donation is per-arity (donate_argnums)

    def wrapper(*args, **kwargs):
        args = shard_batch(args, mesh, batch_dims)
        kwargs = shard_batch(kwargs, mesh, batch_dims)
        key = len(args)
        jitted = jits.get(key)
        if jitted is None:
            jitted = jits.setdefault(key, jax.jit(
                fn, donate_argnums=tuple(range(key)) if donate else ()))
        return jitted(*args, **kwargs)
    return wrapper


def global_stats(x, mesh, axis_name='data'):
    """Cross-device statistics of a sharded field: (finite count, mean, max)
    — the validation reductions that are this workload's only communication.
    Collectives ride the mesh via shard_map + psum/pmax.

    The reductions are isfinite-masked, so a mesh-indivisible batch is
    NaN-padded transparently (shard_map needs even shards); a field with
    zero finite values reports mean NaN, not 0.
    """
    n0 = int(mesh.shape[mesh.axis_names[0]])
    rem = int(x.shape[0]) % n0
    spec = batch_spec(mesh, x.ndim, 1)

    @partial(jax.jit, static_argnames=('pad',))
    def stats(x, pad=0):
        if pad:
            x_ = jnp.concatenate(
                [x, jnp.full((pad,) + x.shape[1:], jnp.nan, x.dtype)])
        else:
            x_ = x

        @partial(jax.shard_map, mesh=mesh, in_specs=(spec,), out_specs=P())
        def body(shard):
            finite = jnp.isfinite(shard)
            cnt = jax.lax.psum(jnp.sum(finite), axis_name)
            tot = jax.lax.psum(jnp.sum(jnp.where(finite, shard, 0.0)),
                               axis_name)
            mx = jax.lax.pmax(jnp.max(jnp.where(finite, shard, -jnp.inf)),
                              axis_name)
            mean = jnp.where(cnt > 0, tot / jnp.maximum(cnt, 1), jnp.nan)
            return cnt, mean, mx

        return body(x_)

    if rem and not np.issubdtype(np.dtype(x.dtype), np.floating):
        raise ValueError(
            f'batch {int(x.shape[0])} does not divide the {n0}-way mesh '
            'axis and non-float fields cannot be NaN-padded — pad to a '
            'multiple first (parallel.pad_batch)')
    return stats(x, pad=(n0 - rem) if rem else 0)
