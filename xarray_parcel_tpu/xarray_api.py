"""xarray ingest/egress shim — the reference-shaped Dataset interface.

The reference is an xarray library: every entry point takes DataArrays with a
named vertical dimension (default ``model_level_number``) and returns
Datasets with ``long_name``/``units`` attrs (reference:
modules/parcel_functions.py passim).  This module is the boundary between
that world and the JAX core: it moves the vertical dim to the trailing axis,
lowers to (optionally mesh-sharded) ``jax.Array``s, runs the jitted pipeline,
and lifts results back to xarray objects with the same variable names and
attrs the reference emits.

The surface mirrors the reference per function — a user migrating
DataArray-based code finds ``lcl``, ``parcel_profile[_with_lcl]``,
``lfc_el``, ``cape_cin``, the three parcel-variant CAPE functions,
``wet_bulb_temperature``, the scalar diagnostics and the pipelines under
the same names with the same ``vert_dim``/``prefix`` keywords
(reference: modules/parcel_functions.py:609, 712, 806, 1066, 1394, 1477,
1557, 1651, 1722, 2216).

xarray is an optional dependency: when installed it is used directly; when
absent the vendored minimal :mod:`xarray_parcel_tpu.xr_lite` provides the
same Dataset/DataArray shape, so this boundary works (and is tested)
everywhere.  Every jitted entry is cached at module level keyed on
(function, static options), so repeated Dataset calls never retrace.

Typical switch from the reference::

    import xarray_parcel_tpu.xarray_api as parcel
    parcel.load_moist_adiabat_lookups()
    out = parcel.conv_properties(dat)          # dat: the same Dataset
    proxies = parcel.storm_proxies(out)

(reference: modules/parcel_functions.py:1951-2100, 2323-2407).
"""

import functools

import jax
import numpy as np

from . import adiabat, native
from . import cape as _cape
from . import diagnostics as _diag
from . import pipeline as _pipeline
from . import profile as _profile
from . import thermo as _thermo
from .adiabat import load_moist_adiabat_lookups  # noqa: F401  (re-export)
from .fieldset import attrs_for
from .lcl import lcl as _lcl
from .parcels import (mixed_layer_cape_cin as _ml_cape_cin,
                      most_unstable_cape_cin as _mu_cape_cin)

try:
    import xarray as xr
    HAVE_XARRAY = True
except ImportError:          # pragma: no cover - exercised only with xarray
    from . import xr_lite as xr
    HAVE_XARRAY = False

DEFAULT_VERT_DIM = 'model_level_number'

# Input variables that carry the vertical dim (everything else is per-column
# surface data, e.g. surface winds).
_LEVEL_VARS = ('pressure', 'temperature', 'specific_humidity', 'dewpoint',
               'height_asl', 'wind_u', 'wind_v',
               'wind_height_above_surface')


# ---------------------------------------------------------------------------
# jit cache: one compiled program per (function, static options), tables and
# data passed as traced pytree arguments — repeated Dataset calls reuse it.
# ---------------------------------------------------------------------------

_JIT_CACHE = {}
_JIT_CACHE_MAX = 256


def _jitted(fn, static_items=()):
    try:
        key = hash((fn, tuple(static_items)))
    except TypeError:
        # An unhashable static option (list/array value): fall back to an
        # uncached jit — correct, just recompiled per call.  That recompile
        # costs seconds, so say so once instead of silently burning it
        # every call.
        import warnings
        warnings.warn(
            f'unhashable static option(s) {[k for k, _ in static_items]!r} '
            f'for {getattr(fn, "__name__", fn)}: every call re-jits '
            '(seconds per call); pass hashable values (tuples, scalars) to '
            'reuse the compiled program', stacklevel=3)
        return jax.jit(functools.partial(fn, **dict(static_items)))
    key = (fn, tuple(static_items))
    if key in _JIT_CACHE:
        jitted = _JIT_CACHE.pop(key)    # re-insert: LRU recency, so the
        _JIT_CACHE[key] = jitted        # hottest programs survive eviction
        return jitted
    if len(_JIT_CACHE) >= _JIT_CACHE_MAX:   # bound process lifetime use
        _JIT_CACHE.pop(next(iter(_JIT_CACHE)))
    _JIT_CACHE[key] = jax.jit(functools.partial(fn, **dict(static_items)))
    return _JIT_CACHE[key]


def _resolve_tables(tables):
    return tables if tables is not None else adiabat.default_tables()


# ---------------------------------------------------------------------------
# Lowering (DataArray/Dataset -> arrays) and lifting (arrays -> Dataset)
# ---------------------------------------------------------------------------

def _is_dataset(obj):
    return hasattr(obj, 'data_vars')


def _batch_dims_of(args, vert_dim):
    """Union of non-vertical dims over EVERY dim-carrying argument, in
    first-appearance order.  Deriving them from one argument alone
    mis-lays mixed-dims inputs (e.g. a 1-D pressure coordinate-variable
    next to (time, lat, lon, level) temperature)."""
    dims = []
    for a in args:
        for d in getattr(a, 'dims', ()):
            if d != vert_dim and d not in dims:
                dims.append(d)
    return tuple(dims)


def _coords_of(args, batch_dims):
    for a in args:
        if hasattr(a, 'coords'):
            return {d: a.coords[d] for d in batch_dims if d in a.coords}
    return {}


def _vert_coord_of(args, vert_dim):
    """Vertical index-coordinate values of the first input that carries one
    (None if no input has a vert_dim coordinate)."""
    if vert_dim is None:
        return None
    for a in args:
        if (hasattr(a, 'dims') and vert_dim in getattr(a, 'dims', ()) and
                hasattr(a, 'coords') and vert_dim in a.coords):
            c = a.coords[vert_dim]
            return np.asarray(c.values if hasattr(c, 'values') else c)
    return None


def _vert_coord_values(vert_coord, size):
    """Coordinate values for a ``size``-level output.

    The reference keeps the vertical index coordinate on spliced outputs by
    shifting above-insertion indices up one (reference:
    modules/parcel_functions.py:977-988, under its increments-of-1 assert),
    so an L+1 output of an L-level input spans min..max+1.  Without an
    input coordinate, a fresh 0..size-1 index is attached so downstream
    ``.sel``/``.isel`` keep working.
    """
    if vert_coord is not None and len(vert_coord) == size:
        return np.asarray(vert_coord)
    if vert_coord is not None and 0 < len(vert_coord) < size:
        v = np.asarray(vert_coord)
        # Continue the coordinate's own step (unit, non-unit or descending
        # indices all stay monotonic/unique); non-numeric or constant
        # coordinates fall back to a fresh index.
        try:
            step = v[-1] - v[-2] if len(v) > 1 else 1
        except TypeError:
            return np.arange(size)
        if step == 0:
            return np.arange(size)
        extra = v[-1] + step * np.arange(1, size - len(v) + 1)
        return np.concatenate([v, extra])
    return np.arange(size)


def _subset_align(v, order, batch_dims):
    """Align a variable carrying only a SUBSET of the batch dims.

    When the present dims form a suffix of ``batch_dims`` (a 1-D pressure
    coordinate-variable, trailing-dim surface winds), numpy's natural
    trailing alignment already broadcasts it correctly against full-batch
    variables, so the array keeps its own shape.  Only when an INTERIOR
    (or leading-misaligned) batch dim is missing are size-1 axes inserted
    for the missing dims — the layout xarray auto-broadcasting gives the
    reference (reference: modules/parcel_functions.py:63-100 passim)."""
    order = tuple(order)
    batch_dims = tuple(batch_dims)
    if not batch_dims or order == batch_dims[len(batch_dims) - len(order):]:
        return v
    shape = tuple(v.shape[order.index(d)] if d in order else 1
                  for d in batch_dims) + v.shape[len(order):]
    return v.reshape(shape)


def _lower(a, vert_dim, batch_dims):
    """One DataArray (or array) -> ndarray, batch dims leading in the shared
    order, vertical dim trailing.  Subset-dim variables align per
    :func:`_subset_align` (natural shape when trailing-aligned, size-1
    axes for missing interior batch dims)."""
    if a is None or np.isscalar(a):
        return a
    if hasattr(a, 'dims'):
        order = tuple(d for d in batch_dims if d in a.dims)
        trail = (vert_dim,) if vert_dim in a.dims else ()
        a = a.transpose(*order, *trail)
        return _subset_align(np.asarray(a.values), order, batch_dims)
    return np.asarray(a)


def _lower_common(args, vert_dim, batch_dims):
    """Lower each argument, then broadcast the level-carrying ones to
    their common shape: a mixed-dims call (1-D pressure coordinate-
    variable next to full-grid temperature) reaches the core functions as
    mutually broadcast arrays, exactly as xarray auto-broadcasting hands
    the reference's functions full-grid operands.  The host views densify
    at device placement — the same cost xarray auto-broadcast pays; the
    Dataset PIPELINES avoid it by broadcasting at trace time instead
    (:func:`_broadcast_run`)."""
    low = [_lower(a, vert_dim, batch_dims) for a in args]
    idx = [i for i, a in enumerate(args)
           if vert_dim is not None and hasattr(a, 'dims')
           and vert_dim in a.dims]
    if len(idx) > 1:
        tgt = np.broadcast_shapes(*(np.shape(low[i]) for i in idx))
        for i in idx:
            if np.shape(low[i]) != tgt:
                low[i] = np.broadcast_to(low[i], tgt)
    return low


def _lift(result, batch_dims, vert_dim=DEFAULT_VERT_DIM, coords=None,
          descriptions=None, vert_coord=None):
    """Dict of (batch…[, L]) arrays -> Dataset with reference attrs.

    Arrays with one more axis than the batch get ``vert_dim`` as their
    trailing dim (profile tracks) and a vertical index coordinate: the
    input's, extended by one for L+1 (LCL-spliced) outputs, or a fresh
    0..L-1 index (see :func:`_vert_coord_values`).
    """
    data_vars = {}
    vert_size = None
    for name, arr in result.items():
        arr = np.asarray(jax.device_get(arr))
        if arr.ndim == len(batch_dims) + 1:
            dims = batch_dims + (vert_dim,)
            vert_size = arr.shape[-1]
        else:
            dims = batch_dims[:arr.ndim]
        attrs = attrs_for(name)
        if descriptions and name in descriptions:
            attrs['description'] = descriptions[name]
        data_vars[name] = (dims, arr, attrs)
    ds = xr.Dataset(data_vars)
    assign = {k: v for k, v in (coords or {}).items() if k in ds.dims}
    if vert_size is not None:
        assign[vert_dim] = _vert_coord_values(vert_coord, vert_size)
    if assign:
        ds = ds.assign_coords(assign)
    return ds


def _lift_da(arr, batch_dims, vert_dim=DEFAULT_VERT_DIM, coords=None,
             name=None, vert_coord=None):
    """One array -> DataArray (helper for scalar-field entry points)."""
    arr = np.asarray(jax.device_get(arr))
    vert_size = None
    if arr.ndim == len(batch_dims) + 1:
        dims = batch_dims + (vert_dim,)
        vert_size = arr.shape[-1]
    else:
        dims = batch_dims[:arr.ndim]
    if vert_size is not None:
        coords = dict(coords or {})
        coords[vert_dim] = _vert_coord_values(vert_coord, vert_size)
    da = xr.DataArray(arr, dims=dims, attrs=attrs_for(name) if name else {},
                      name=name)
    if coords:
        keep = {k: v for k, v in coords.items() if k in da.dims}
        if hasattr(da, 'assign_coords'):
            try:
                da = da.assign_coords(keep)
            except (AttributeError, TypeError):
                pass
        else:
            # xr_lite DataArrays take coords at construction only — rebuild
            # so the vendored-shim egress keeps coordinates like the real
            # xarray path does.
            da = xr.DataArray(arr, dims=dims, coords=keep,
                              attrs=attrs_for(name) if name else {},
                              name=name)
    return da


def _rename(ds_dict, prefix, keys):
    if prefix is None:
        return ds_dict
    return {(f'{prefix}_{k}' if k in keys else k): v
            for k, v in ds_dict.items()}


def from_dataset(dat, vert_dim=DEFAULT_VERT_DIM, variables=None, mesh=None,
                 dtype=np.float32):
    """Lower a Dataset to a dict of arrays (vertical dim trailing).

    Returns ``(fields, batch_dims)`` where ``batch_dims`` is the ordered
    tuple of non-vertical dims (used by :func:`to_dataset` to lift results
    back).  Without ``mesh`` the fields are host (numpy) arrays — jit moves
    them to device on first use, avoiding a double placement; with ``mesh``
    they are ``jax.Array``s sharded over its leading axis (the JAX analogue
    of the reference's dask chunking,
    reference: modules/parcel_functions.py:561-592).  Here the mesh size
    must divide the LEADING batch dim (XLA divisibility), because this
    function returns fields at the input's batch shape; the pipeline entry
    points (``conv_properties(dat, mesh=...)`` etc.) accept ANY grid —
    they pad -> shard -> compute -> slice internally, exactly as the
    reference's dask chunking accepts arbitrary grids (reference:
    modules/parcel_functions.py:561-579) — as does streaming
    (``stream_columns=`` + ``mesh=``).  For direct use on a non-divisible
    grid, pad via ``parallel.pad_batch`` first and slice results yourself.
    """
    names = variables or [v for v in _LEVEL_VARS if v in dat] + \
        [v for v in ('surface_wind_u', 'surface_wind_v') if v in dat]
    if not names:
        raise ValueError(
            'Dataset carries none of the recognized variables '
            f'{_LEVEL_VARS + ("surface_wind_u", "surface_wind_v")}')
    # Batch dims = the union of non-vertical dims over ALL selected
    # variables, in first-appearance order: deriving them from one
    # variable alone mis-lays grids where that variable carries fewer
    # dims than the rest (e.g. a 1-D pressure coordinate-variable next
    # to (time, lat, lon, level) temperature).
    batch_dims = []
    for n in names:
        batch_dims += [d for d in dat[n].dims
                       if d != vert_dim and d not in batch_dims]
    batch_dims = tuple(batch_dims)

    dtype = np.dtype(dtype)
    fields = {}
    for name in names:
        da = dat[name]
        # Every variable is put in the SAME batch-dim order (variables may
        # legally carry differently ordered dims in xarray).
        order = tuple(d for d in batch_dims if d in da.dims)
        if dtype != np.float32:
            # Dtype-preserving/upcast path (e.g. serving an f64 artifact:
            # the default f32 repack would silently round its inputs).
            da = da.transpose(*order, *((vert_dim,) if vert_dim in da.dims
                                        else ()))
            v = np.ascontiguousarray(np.asarray(da.values))
            v = (v.astype(dtype, copy=False)
                 if v.dtype.kind == 'f' else v)
        elif da.dims == (vert_dim,) + order and da.ndim > 1:
            # Native repack: leading level axis -> trailing, f32 (native/).
            v = native.levels_to_last(np.asarray(da.values))
        else:
            da = da.transpose(*order, *((vert_dim,) if vert_dim in da.dims
                                        else ()))
            v = native.repack_to_f32(np.asarray(da.values))
        fields[name] = _subset_align(v, order, batch_dims)

    if mesh is not None:
        from .parallel import shard_batch
        if not batch_dims:
            raise ValueError(
                'mesh= needs at least one non-vertical (batch) dim to '
                'shard — a single-column Dataset would shard its LEVEL '
                'axis across devices')
        # Subset-dim variables (a 1-D pressure coordinate-variable,
        # time-invariant surface winds) must cover the full batch before
        # the leading axis is sharded, or shard_batch would split a
        # NON-batch axis across devices.  broadcast_to views are free on
        # the host; they materialize per shard at device_put.
        fields = _broadcast_fields(fields, dat, batch_dims, vert_dim)
        lead = next(iter(fields.values())).shape[0]
        if lead % mesh.devices.size:
            raise ValueError(
                f'mesh size {mesh.devices.size} does not divide the leading '
                f'batch dim {lead}; the pipeline entry points '
                f'(conv_properties(dat, mesh=...)) pad automatically, or '
                f'pad via parallel.pad_batch before from_dataset')
        fields = shard_batch(fields, mesh, batch_dims=1)
    return fields, batch_dims


def _batch_shape_of(fields, dat, batch_dims, vert_dim):
    """(full batch shape, names of vert-carrying fields) for broadcasting
    subset-dim variables onto the grid."""
    sizes = {}
    for name in fields:
        for d, s in zip(dat[name].dims, dat[name].shape):
            if d != vert_dim:
                sizes[d] = int(s)
    batch_shape = tuple(sizes[d] for d in batch_dims)
    vert_names = frozenset(n for n in fields if vert_dim in dat[n].dims)
    return batch_shape, vert_names


def _broadcast_fields(fields, dat, batch_dims, vert_dim):
    """Broadcast each lowered field onto the FULL batch shape (as zero-copy
    host views) so leading-axis chunking/padding/sharding is well-defined
    for variables that carry only a subset of the batch dims.  Fields may
    arrive at their natural (trailing-aligned) shape or with size-1 axes
    for missing interior dims; both broadcast to the full target.  The
    views densify at device placement — used only where a real leading
    batch axis is required (sharding, chunking, column flattening); the
    plain pipeline path broadcasts at trace time instead
    (:func:`_broadcast_run`)."""
    batch_shape, vert_names = _batch_shape_of(fields, dat, batch_dims,
                                              vert_dim)
    out = {}
    for name, v in fields.items():
        target = batch_shape + (v.shape[-1:] if name in vert_names else ())
        out[name] = v if v.shape == target else np.broadcast_to(v, target)
    return out


def _broadcast_run(fields, tables=None, _fn=None, _batch_shape=(),
                   _vert_names=frozenset(), **kwargs):
    """Jitted adapter: broadcast subset-dim fields onto the full batch at
    TRACE time (an XLA broadcast fuses for free on device), so a 1-D
    pressure coordinate-variable ships ~L floats host->device instead of
    a densified full-grid copy."""
    import jax.numpy as jnp
    expanded = {
        k: jnp.broadcast_to(
            v, tuple(_batch_shape) +
            ((v.shape[-1],) if k in _vert_names else ()))
        for k, v in fields.items()}
    return _fn(expanded, tables=tables, **kwargs)


def to_dataset(result, batch_dims, coords=None, vert_dim=DEFAULT_VERT_DIM):
    """Lift a dict of (batch…) arrays to a Dataset with reference attrs."""
    return _lift(result, tuple(batch_dims), vert_dim=vert_dim, coords=coords)


# ---------------------------------------------------------------------------
# Pipelines (Dataset in / Dataset out)
# ---------------------------------------------------------------------------

_PIPELINE_DOC_EXTRA = """Dataset-surface extras: ``stream_columns`` \
processes the grid out-of-core in chunks of that many columns (the \
dask-chunking analogue; one compile, chunk transfers overlap compute — \
see ``parallel.stream_map``).  With ``mesh`` as well, each chunk shards \
over the mesh, so grids larger than one device's HBM stream through all \
devices SPMD."""


def _dataset_pipeline(fn):
    @functools.wraps(fn)
    def wrapper(dat, vert_dim=DEFAULT_VERT_DIM, tables=None, mesh=None,
                stream_columns=None, **kwargs):
        # When streaming, the full grid must never be device_put whole —
        # chunks are placed (and mesh-sharded) one at a time inside
        # stream_map.  The registry pipelines derive dewpoint from
        # specific humidity and never read a provided 'dewpoint'
        # variable, so exclude it from the ingest (a full-grid repack +
        # transfer XLA would only dead-code-eliminate).
        use = [v for v in _LEVEL_VARS + ('surface_wind_u', 'surface_wind_v')
               if v != 'dewpoint' and v in dat]
        fields, batch_dims = from_dataset(dat, vert_dim=vert_dim,
                                          variables=use, mesh=None)
        if (mesh is not None or stream_columns) and not batch_dims:
            raise ValueError(
                'mesh=/stream_columns= need at least one non-vertical '
                '(batch) dim — a single-column Dataset would chunk/shard '
                'its LEVEL axis')
        # The pipeline cores assume shape-uniform inputs (e.g. mix_layer
        # broadcasts temperature to pressure.shape).  On the mesh/stream
        # paths every field gets a REAL full batch shape via host views
        # (leading-axis padding/chunking/sharding must never split a
        # non-batch axis of a subset-dim variable); on the plain path
        # subset-dim fields stay at their natural size and broadcast at
        # trace time, so only ~their own bytes cross to the device.
        batch_shape, vert_names = _batch_shape_of(fields, dat, batch_dims,
                                                  vert_dim)
        uniform = all(
            v.shape == batch_shape + (v.shape[-1:] if n in vert_names
                                      else ())
            for n, v in fields.items())
        if mesh is not None or stream_columns:
            fields = _broadcast_fields(fields, dat, batch_dims, vert_dim)
        tables = _resolve_tables(tables)
        if uniform or mesh is not None or stream_columns:
            run = _jitted(fn, sorted(kwargs.items()))
        else:
            run = _jitted(_broadcast_run,
                          (('_fn', fn), ('_batch_shape', batch_shape),
                           ('_vert_names', vert_names),
                           *sorted(kwargs.items())))
        if stream_columns:
            from .parallel import stream_map
            out = stream_map(lambda d: run(d, tables=tables), fields,
                             batch_columns=stream_columns, jit=False,
                             mesh=mesh)
        elif mesh is not None:
            # Any grid shards: pad the leading batch dim to a mesh
            # multiple (columns are independent, NaN rows are inert),
            # compute sharded, slice the padding back off — the reference's
            # dask chunking likewise accepts arbitrary grid shapes
            # (reference: modules/parcel_functions.py:561-579).
            from .parallel import pad_batch, shard_batch
            fields, lead = pad_batch(fields, mesh)
            fields = shard_batch(fields, mesh, batch_dims=1)
            out = run(fields, tables=tables)
            out = {k: (v[:lead] if getattr(v, 'ndim', 0) else v)
                   for k, v in out.items()}
        else:
            out = run(fields, tables=tables)
        coords = {d: dat.coords[d] for d in batch_dims if d in dat.coords}
        return to_dataset(out, batch_dims, coords=coords, vert_dim=vert_dim)
    # functools.wraps copied fn's docstring; append the Dataset-surface
    # extras so they are actually reachable from help().
    wrapper.__doc__ = ((fn.__doc__ or '').rstrip() + '\n\n' +
                       _PIPELINE_DOC_EXTRA)
    return wrapper


conv_properties = _dataset_pipeline(_pipeline.conv_properties)
conv_properties_fused = _dataset_pipeline(_pipeline.conv_properties_fused)
min_conv_properties = _dataset_pipeline(_pipeline.min_conv_properties)
min_conv_properties_fused = _dataset_pipeline(
    _pipeline.min_conv_properties_fused)


def serve(dat, artifact, vert_dim=DEFAULT_VERT_DIM, tables=None, mesh=None):
    """Run a Dataset through an AOT serving artifact
    (``deploy.export_pipeline`` / ``deploy.load``) — Dataset in, attributed
    Dataset out, with zero retracing in the serving process.

    ``artifact`` is a ``deploy.Deployed`` or a path to a saved one.  Any
    grid shape works: batch dims flatten to the artifact's column axis
    and the artifact pads/chunks onto its exported batch (sharding each
    chunk when it was exported with ``mesh=``; pass ``mesh=`` here to
    override the serving mesh).  The reference has no analogue — every
    dask session re-builds its graph before the first chunk computes.
    """
    from . import deploy as _deploy
    if not isinstance(artifact, _deploy.Deployed):
        artifact = _deploy.load(artifact)
    want = np.dtype(artifact.meta.get('dtype', 'float32'))
    if want.itemsize == 8 and not jax.config.jax_enable_x64:
        # With x64 off, JAX canonicalizes every f64 input to f32 and the
        # export-layer dtype check fails; enabling x64 here would change
        # dtype semantics process-wide behind the caller's back, so name
        # the remedy instead (the deploy CLI, a self-contained process,
        # does enable it itself).
        raise ValueError(
            'this artifact was exported at float64 but jax_enable_x64 '
            'is off — jax.config.update("jax_enable_x64", True) before '
            'serving, or serve via `python -m xarray_parcel_tpu.deploy '
            'serve`, which enables it itself')
    # The artifact's input pytree is the fixed pipeline contract
    # (deploy.input_spec): select exactly the exported variables BEFORE
    # lowering (no wasted full-grid repack of recognized-but-unexported
    # ones like dewpoint) and fail missing ones with a clear message
    # rather than jax.export's treedef mismatch.
    kept, missing, _extra = artifact.check_inputs(
        dict.fromkeys(getattr(dat, 'data_vars', dat)))
    if missing:
        raise ValueError(
            f'Dataset is missing variables the artifact requires: '
            f'{missing}')
    names = [v for v in _LEVEL_VARS + ('surface_wind_u', 'surface_wind_v')
             if v in kept]
    # Lower at the artifact's dtype: the default f32 repack would
    # silently round the inputs of an f64-exported artifact.
    fields, batch_dims = from_dataset(dat, vert_dim=vert_dim,
                                      variables=names, dtype=want)
    nb = len(batch_dims)
    # A variable may carry only a subset of the batch dims (e.g.
    # time-invariant surface winds on a time+lat+lon grid) — broadcast to
    # the full batch shape before flattening onto the column axis.
    fields = _broadcast_fields(fields, dat, batch_dims, vert_dim)
    batch_shape = (next(iter(fields.values())).shape[:nb]
                   if fields else ())

    def flat_one(v):
        v = np.reshape(np.asarray(v), (-1,) + np.shape(v)[nb:])
        # Floats only: from_dataset deliberately preserves int/bool
        # variables, which the export layer expects un-cast.
        return v.astype(want, copy=False) if v.dtype.kind == 'f' else v

    flat = {k: flat_one(v) for k, v in fields.items()}
    # Pass tables through UN-resolved: Deployed auto-loads the artifact's
    # recorded table dtype in a fresh serving process (deploy.py), which
    # this process's own default tables need not match.
    out = artifact(flat, tables=tables, mesh=mesh)
    # Materialize through Deployed's host gatherer: the exact-fit path
    # returns device arrays that span non-addressable devices under
    # multi-process SPMD serving, where a raw np.asarray would raise.
    out = artifact._host(out)
    out = {k: np.asarray(v).reshape(batch_shape + np.shape(v)[1:])
           for k, v in out.items()}
    coords = {d: dat.coords[d] for d in batch_dims if d in dat.coords}
    return to_dataset(out, batch_dims, coords=coords, vert_dim=vert_dim)


def storm_proxies(conv, vert_dim=DEFAULT_VERT_DIM):
    """Storm proxies from a conv_properties Dataset
    (reference: modules/parcel_functions.py:2323-2407)."""
    needed = _pipeline.STORM_PROXY_INPUTS
    missing = [k for k in needed if k not in conv.data_vars]
    if missing:
        raise ValueError('storm_proxies needs the conv_properties output '
                         f'variables {missing}')
    # Subset to exactly the variables the proxies read: a merged Dataset
    # may carry extra (even level-carrying) variables, which must neither
    # force a retrace per distinct variable set nor hit transpose with an
    # incomplete dim permutation.
    das = [conv[k] for k in needed]
    batch_dims = _batch_dims_of(das, vert_dim)
    # Normalize every variable to the shared dim order — merged Datasets
    # may legally carry permuted dims per variable.
    fields = {k: _lower(conv[k], None, batch_dims) for k in needed}
    out = _jitted(_pipeline.storm_proxies)(fields)
    coords = {d: conv.coords[d] for d in batch_dims if d in conv.coords}
    return to_dataset(out, batch_dims, coords=coords)


def valid_data(dat, vert_dim=DEFAULT_VERT_DIM, strict=True):
    """Validate the reference's input invariants on a Dataset: the vertical
    index coordinate increments by exactly 1 between levels, and pressure
    strictly decreases with level (reference:
    modules/parcel_functions.py:2308-2321).  The pressure half runs through
    the native ingest runtime per column; the increment half is a
    whole-coordinate property.  Returns the per-column validity mask (all
    False when the coordinate itself is invalid); with ``strict`` raises
    ValueError on any violation."""
    from . import api as _api
    batch_dims = _batch_dims_of([dat['pressure']], vert_dim)
    p = _lower(dat['pressure'], vert_dim, batch_dims)
    vert = None
    if hasattr(dat, 'coords') and vert_dim in getattr(dat, 'coords', {}):
        c = dat.coords[vert_dim]
        vert = np.asarray(c.values if hasattr(c, 'values') else c)
    else:
        vert = _vert_coord_of([dat['pressure']], vert_dim)
    if vert is not None and len(vert) > 1:
        try:
            unit = bool(np.all(np.abs(np.diff(
                np.asarray(vert, dtype=float))) == 1))
        except (TypeError, ValueError):
            unit = False      # non-numeric coord cannot be a unit index
        if not unit:
            if strict:
                raise ValueError('Index increments must all be 1.')
            return np.zeros(np.asarray(p).shape[:-1], dtype=bool)
    return _api.valid_data({'pressure': np.asarray(p)}, strict=strict)


# ---------------------------------------------------------------------------
# Per-function surface (DataArray in / Dataset or DataArray out)
# ---------------------------------------------------------------------------

def lcl(parcel_pressure, parcel_temperature, parcel_dewpoint):
    """Lifting condensation level for parcels
    (reference: modules/parcel_functions.py:609-682).  NaN inputs give NaN
    outputs (no dummy-value substitution needed — the solver is
    NaN-transparent)."""
    args = (parcel_pressure, parcel_temperature, parcel_dewpoint)
    batch_dims = _batch_dims_of(args, vert_dim=None)
    low = [_lower(a, None, batch_dims) for a in args]
    out = _jitted(_lcl)(*low)
    return _lift(out, batch_dims, coords=_coords_of(args, batch_dims))


def parcel_profile(pressure, parcel_pressure, parcel_temperature,
                   parcel_dewpoint, vert_dim=DEFAULT_VERT_DIM, tables=None,
                   moist_lapse=None):
    """Temperatures of a lifted parcel
    (reference: modules/parcel_functions.py:712-780)."""
    args = (pressure, parcel_pressure, parcel_temperature, parcel_dewpoint)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_profile.parcel_profile,
                  (('moist_lapse', moist_lapse),))
    out = run(low[0], low[1], low[2], low[3],
              tables=_resolve_tables(tables))
    return _lift(out, batch_dims, vert_dim=vert_dim,
                 coords=_coords_of(args, batch_dims),
                 vert_coord=_vert_coord_of(args, vert_dim))


def parcel_profile_with_lcl(pressure, temperature, dewpoint, parcel_pressure,
                            parcel_temperature, parcel_dewpoint,
                            vert_dim=DEFAULT_VERT_DIM, lcl_interp='log',
                            tables=None, moist_lapse=None):
    """Parcel profile including the LCL level, plus the environment tracks
    spliced at the LCL (reference: modules/parcel_functions.py:806-856).
    Output columns have L+1 levels."""
    args = (pressure, temperature, dewpoint, parcel_pressure,
            parcel_temperature, parcel_dewpoint)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_profile.parcel_profile_with_lcl,
                  (('lcl_interp', lcl_interp), ('moist_lapse', moist_lapse)))
    out = run(*low, tables=_resolve_tables(tables))
    return _lift(out, batch_dims, vert_dim=vert_dim,
                 coords=_coords_of(args, batch_dims),
                 vert_coord=_vert_coord_of(args, vert_dim))


def lfc_el(pressure, parcel_temperature, temperature, lcl_pressure,
           lcl_temperature, vert_dim=DEFAULT_VERT_DIM):
    """Level of free convection and equilibrium level
    (reference: modules/parcel_functions.py:1066-1198)."""
    args = (pressure, parcel_temperature, temperature, lcl_pressure,
            lcl_temperature)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    out = _jitted(_cape.lfc_el)(*low)
    return _lift(out, batch_dims, coords=_coords_of(args, batch_dims))


def cape_cin(pressure, temperature, dewpoint, parcel_temperature,
             parcel_pressure, parcel_dewpoint, vert_dim=DEFAULT_VERT_DIM,
             tables=None, **kwargs):
    """CAPE/CIN for an arbitrary parcel; returns (Dataset, profile Dataset)
    (reference: modules/parcel_functions.py:1394-1475)."""
    args = (pressure, temperature, dewpoint, parcel_temperature,
            parcel_pressure, parcel_dewpoint)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_cape.cape_cin, sorted(kwargs.items()))
    res, profile = run(low[0], low[1], low[2], low[3], low[4], low[5],
                       tables=_resolve_tables(tables))
    coords = _coords_of(args, batch_dims)
    return (_lift(res, batch_dims, coords=coords),
            _lift(profile, batch_dims, vert_dim=vert_dim, coords=coords,
                  vert_coord=_vert_coord_of(args, vert_dim)))


def _cape_variant(core, res_extras):
    """Shared wrapper for the three parcel-choice CAPE entry points."""
    def wrapper(pressure, temperature, dewpoint,
                vert_dim=DEFAULT_VERT_DIM, prefix=None, tables=None,
                **kwargs):
        if _is_dataset(pressure):
            raise TypeError(
                'pass pressure/temperature/dewpoint DataArrays (the '
                'reference signature); for Dataset-level pipelines use '
                'conv_properties / surface_based_cape_cin_dataset')
        args = (pressure, temperature, dewpoint)
        batch_dims = _batch_dims_of(args, vert_dim)
        low = _lower_common(args, vert_dim, batch_dims)
        run = _jitted(core, sorted(kwargs.items()))
        out = run(*low, tables=_resolve_tables(tables))
        res, rest = out[0], out[1:]
        coords = _coords_of(args, batch_dims)
        desc = res_extras(kwargs)
        if prefix and desc:
            # _lift matches descriptions against the RENAMED keys.
            desc = {f'{prefix}_{k}': v for k, v in desc.items()}
        res = _lift(_rename(res, prefix, ('cape', 'cin')), batch_dims,
                    coords=coords, descriptions=desc)
        vc = _vert_coord_of(args, vert_dim)
        lifted = tuple(_lift(r, batch_dims, vert_dim=vert_dim, coords=coords,
                             vert_coord=vc)
                       for r in rest)
        return (res,) + lifted
    return wrapper


surface_based_cape_cin = _cape_variant(
    _cape.surface_based_cape_cin,
    lambda kw: {'cape': 'CAPE for surface-based parcel.',
                'cin': 'CIN for surface-based parcel.'})
surface_based_cape_cin.__doc__ = (
    'Surface-based CAPE and CIN; returns (Dataset, profile Dataset) '
    '(reference: modules/parcel_functions.py:1477-1514).')


def _mu_desc(kwargs):
    depth = kwargs.get('depth', 300)
    d = f'most-unstable parcel in lowest {depth} hPa.'
    return {'cape': f'CAPE for {d}', 'cin': f'CIN for {d}'}


def _ml_desc(kwargs):
    depth = kwargs.get('depth', 100)
    d = f'fully-mixed lowest {depth} hPa parcel'
    return {'cape': f'CAPE for {d}.', 'cin': f'CIN for {d}'}


most_unstable_cape_cin = _cape_variant(_mu_cape_cin, _mu_desc)
most_unstable_cape_cin.__doc__ = (
    'Most-unstable-parcel CAPE/CIN; returns (Dataset, profile Dataset, '
    'parcel Dataset) (reference: modules/parcel_functions.py:1557-1602).')

mixed_layer_cape_cin = _cape_variant(_ml_cape_cin, _ml_desc)
mixed_layer_cape_cin.__doc__ = (
    'Fully-mixed-layer CAPE/CIN; returns (Dataset, profile Dataset, parcel '
    'Dataset) (reference: modules/parcel_functions.py:1651-1697).')


def _fused_sb_core(p, t, td, tables=None, **kw):
    from .fused import fused_surface_cape_cin
    res, sol = fused_surface_cape_cin(p, t, td, tables=tables, **kw)
    return dict(res, **sol)


def _xla_sb_core(p, t, td, tables=None, **kw):
    res, _ = _cape.surface_based_cape_cin(p, t, td, tables=tables, **kw)
    return res


def surface_based_cape_cin_dataset(dat, vert_dim=DEFAULT_VERT_DIM,
                                   tables=None, fused=True, **kwargs):
    """Surface-based CAPE/CIN from a Dataset with pressure / temperature /
    dewpoint variables.  With ``fused`` the fused production solve is used
    (no profile output; LFC/EL included in the result)."""
    fields, batch_dims = from_dataset(
        dat, vert_dim=vert_dim,
        variables=['pressure', 'temperature', 'dewpoint'])
    tables = _resolve_tables(tables)
    # Module-level cores: the jit cache is keyed on the function object, so
    # per-call closures would retrace (a whole-solve compile) every call.
    core = _fused_sb_core if fused else _xla_sb_core
    res = _jitted(core, sorted(kwargs.items()))(
        fields['pressure'], fields['temperature'], fields['dewpoint'],
        tables=tables)
    coords = {d: dat.coords[d] for d in batch_dims if d in dat.coords}
    return to_dataset(res, batch_dims, coords=coords)


def lifted_index(profile, vert_dim=DEFAULT_VERT_DIM, description=None,
                 prefix=None):
    """Galway lifted index from a parcel_profile_with_lcl Dataset
    (reference: modules/parcel_functions.py:1722-1756)."""
    batch_dims = tuple(d for d in profile['pressure'].dims if d != vert_dim)
    fields = {k: _lower(profile[k], vert_dim, batch_dims)
              for k in ('pressure', 'temperature', 'environment_temperature')}
    out = _rename(_jitted(_diag.lifted_index)(fields), prefix,
                  ('lifted_index',))
    key = f'{prefix}_lifted_index' if prefix else 'lifted_index'
    desc = {key: description} if description else None
    coords = _coords_of([profile[k] for k in profile.data_vars], batch_dims)
    return _lift(out, batch_dims, coords=coords, descriptions=desc)


def deep_convective_index(pressure, temperature, dewpoint, lifted_index,
                          vert_dim=DEFAULT_VERT_DIM, prefix=None,
                          description=None):
    """Kunz DCI (reference: modules/parcel_functions.py:1830-1870)."""
    args = (pressure, temperature, dewpoint, lifted_index)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    out = _jitted(_diag.deep_convective_index)(*low)
    out = _rename(out, prefix, ('dci',))
    key = f'{prefix}_dci' if prefix else 'dci'
    desc = {key: description} if description else None
    return _lift(out, batch_dims, coords=_coords_of(args, batch_dims),
                 descriptions=desc)


def wet_bulb_temperature(pressure, temperature, dewpoint,
                         vert_dim=DEFAULT_VERT_DIM, tables=None,
                         moist_lapse=None):
    """Exact wet-bulb temperature (fully vectorised Normand's rule;
    reference: modules/parcel_functions.py:389-445)."""
    args = (pressure, temperature, dewpoint)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_diag.wet_bulb_temperature,
                  (('moist_lapse', moist_lapse),))
    out = run(*low, tables=_resolve_tables(tables))
    return _lift_da(out, batch_dims, vert_dim=vert_dim,
                    coords=_coords_of(args, batch_dims),
                    name='wet_bulb_temperature',
                    vert_coord=_vert_coord_of(args, vert_dim))


def wet_bulb_temperature_fast(temperature, dewpoint):
    """Knox (2017) one-third-rule wet bulb
    (reference: modules/parcel_functions.py:364-387)."""
    args = (temperature, dewpoint)
    batch_dims = _batch_dims_of(args, None)
    low = [_lower(a, None, batch_dims) for a in args]
    out = _jitted(_thermo.wet_bulb_temperature_fast)(*low)
    return _lift_da(out, batch_dims, coords=_coords_of(args, batch_dims),
                    name='wet_bulb_temperature')


def lapse_rate(pressure, temperature, height, from_pressure=700.0,
               to_pressure=500.0, vert_dim=DEFAULT_VERT_DIM):
    """Lapse rate between two pressure levels
    (reference: modules/parcel_functions.py:2102-2135)."""
    args = (pressure, temperature, height)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_diag.lapse_rate, (('from_pressure', float(from_pressure)),
                                     ('to_pressure', float(to_pressure))))
    # Name follows the layer actually computed ('lapse_rate_700_500' at
    # the reference defaults).
    return _lift_da(run(*low), batch_dims,
                    coords=_coords_of(args, batch_dims),
                    name=f'lapse_rate_{from_pressure:g}_{to_pressure:g}')


def isobar_temperature(pressure, temperature, isobar,
                       vert_dim=DEFAULT_VERT_DIM):
    """Temperature at a pressure level
    (reference: modules/parcel_functions.py:2193-2214)."""
    args = (pressure, temperature)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_diag.isobar_temperature, (('isobar', float(isobar)),))
    # Name follows the isobar actually evaluated ('temp_500' at the
    # reference default).
    return _lift_da(run(*low), batch_dims,
                    coords=_coords_of(args, batch_dims),
                    name=f'temp_{isobar:g}')


def freezing_level_height(temperature, height, vert_dim=DEFAULT_VERT_DIM):
    """Height of the 0 C dry-bulb isotherm
    (reference: modules/parcel_functions.py:2137-2160)."""
    args = (temperature, height)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    return _lift_da(_jitted(_diag.freezing_level_height)(*low), batch_dims,
                    coords=_coords_of(args, batch_dims),
                    name='freezing_level')


def _mlh_core(p, t, td, h, tables=None, fast=True):
    mlh, _ = _diag.melting_level_height(p, t, td, h, fast=fast,
                                        tables=tables)
    return mlh


def melting_level_height(pressure, temperature, dewpoint, height, fast=True,
                         vert_dim=DEFAULT_VERT_DIM, tables=None):
    """Height of the 0 C wet-bulb isotherm
    (reference: modules/parcel_functions.py:2162-2191)."""
    args = (pressure, temperature, dewpoint, height)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_mlh_core, (('fast', bool(fast)),))
    return _lift_da(run(*low, tables=_resolve_tables(tables)), batch_dims,
                    coords=_coords_of(args, batch_dims),
                    name='melting_level')


def wind_shear(surface_wind_u, surface_wind_v, wind_u, wind_v, height,
               shear_height=6000.0, vert_dim=DEFAULT_VERT_DIM):
    """Bulk wind shear to ``shear_height``
    (reference: modules/parcel_functions.py:2216-2259)."""
    args = (surface_wind_u, surface_wind_v, wind_u, wind_v, height)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_diag.wind_shear, (('shear_height', float(shear_height)),))
    return _lift(run(*low), batch_dims, coords=_coords_of(args, batch_dims))


def significant_hail_parameter(mucape, mixing_ratio, lapse, temp_500, shear,
                               flh):
    """SPC significant hail parameter
    (reference: modules/parcel_functions.py:2261-2306)."""
    args = (mucape, mixing_ratio, lapse, temp_500, shear, flh)
    batch_dims = _batch_dims_of(args, None)
    low = [_lower(a, None, batch_dims) for a in args]
    out = _jitted(_diag.significant_hail_parameter)(*low)
    return _lift_da(out, batch_dims, coords=_coords_of(args, batch_dims),
                    name='ship')


def dry_lapse(pressure, parcel_temperature, parcel_pressure=None,
              vert_dim=DEFAULT_VERT_DIM):
    """Dry adiabat along a column (reference:
    modules/parcel_functions.py:291-316)."""
    from . import api as _api
    args = (pressure, parcel_temperature, parcel_pressure)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    out = _jitted(_api.dry_lapse)(low[0], low[1]) if low[2] is None else \
        _jitted(_api.dry_lapse)(low[0], low[1], low[2])
    return _lift_da(out, batch_dims, vert_dim=vert_dim,
                    coords=_coords_of(args, batch_dims), name='temperature',
                    vert_coord=_vert_coord_of(args, vert_dim))


def moist_lapse(pressure, parcel_temperature, parcel_pressure=None,
                vert_dim=DEFAULT_VERT_DIM, tables=None):
    """Moist adiabat along a column via the spectral table consumer
    (reference: modules/parcel_functions.py:525-607)."""
    args = (pressure, parcel_temperature, parcel_pressure)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    tables = _resolve_tables(tables)
    if low[2] is None:
        out = _jitted(adiabat.moist_lapse)(low[0], low[1], tables=tables)
    else:
        out = _jitted(adiabat.moist_lapse)(low[0], low[1], low[2],
                                           tables=tables)
    return _lift_da(out, batch_dims, vert_dim=vert_dim,
                    coords=_coords_of(args, batch_dims), name='temperature',
                    vert_coord=_vert_coord_of(args, vert_dim))


def mixing_ratio(temperature, dewpoint, pressure):
    """Mixing ratio via the reference's RH route
    (reference: modules/parcel_functions.py:684-710)."""
    args = (temperature, dewpoint, pressure)
    batch_dims = _batch_dims_of(args, None)
    low = [_lower(a, None, batch_dims) for a in args]
    out = _jitted(_thermo.mixing_ratio)(*low)
    return _lift_da(out, batch_dims, coords=_coords_of(args, batch_dims),
                    name='mixing_ratio')


def dewpoint_from_specific_humidity(pressure, temperature, specific_humidity,
                                    vert_dim=DEFAULT_VERT_DIM):
    """Dewpoint from specific humidity via the reference's RH chain — the
    derivation the registry pipelines use internally
    (reference: modules/parcel_functions.py:1888-1894, 1968-1974)."""
    args = (pressure, temperature, specific_humidity)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    out = _jitted(_thermo.dewpoint_from_specific_humidity)(*low)
    return _lift_da(out, batch_dims, vert_dim=vert_dim,
                    coords=_coords_of(args, batch_dims), name='dewpoint',
                    vert_coord=_vert_coord_of(args, vert_dim))


def dewpoint_from_relative_humidity(temperature, relative_humidity,
                                    vert_dim=DEFAULT_VERT_DIM):
    """Dewpoint from relative humidity (invert Bolton at e = RH * e_s(T))."""
    args = (temperature, relative_humidity)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    out = _jitted(_thermo.dewpoint_from_relative_humidity)(*low)
    return _lift_da(out, batch_dims, vert_dim=vert_dim,
                    coords=_coords_of(args, batch_dims), name='dewpoint',
                    vert_coord=_vert_coord_of(args, vert_dim))


def virtual_temperature(temperature, mixing_ratio, epsilon=0.608):
    """Doswell-Rasmussen virtual temperature
    (reference: modules/parcel_functions.py:782-804)."""
    args = (temperature, mixing_ratio)
    batch_dims = _batch_dims_of(args, None)
    low = [_lower(a, None, batch_dims) for a in args]
    run = _jitted(_thermo.virtual_temperature,
                  (('epsilon', float(epsilon)),))
    return _lift_da(run(*low), batch_dims,
                    coords=_coords_of(args, batch_dims),
                    name='virtual_temperature')


# ---------------------------------------------------------------------------
# Ops-level surface: the reference exposes ALL its building blocks as xarray
# functions (reference: modules/parcel_functions.py:63-289, :933-1064,
# :1699-1828); these wrappers complete that parity so custom diagnostics can
# be composed from DataArrays exactly as the reference's demo notebook does.
# ---------------------------------------------------------------------------

from . import ops as _ops                              # noqa: E402
from . import parcels as _parcels                      # noqa: E402


def _fields_of(dat, vert_dim, names=None):
    """Dataset/dict of DataArrays -> (fields dict, batch_dims, vert_coord,
    coords).

    Without ``names``, Dataset input is subset to the variables that carry
    ``vert_dim`` — surface (non-level) variables riding along in the same
    Dataset (winds, ids, masks) are not part of a vertical-column op and
    would otherwise break the fixed-shape lowering."""
    if _is_dataset(dat):
        if names is None:
            names = [k for k in dat.data_vars
                     if vert_dim in getattr(dat[k], 'dims', ())]
            if not names:
                raise ValueError(
                    f'no data variable carries the vertical dim '
                    f'{vert_dim!r}; pass names= to select variables '
                    f'explicitly or vert_dim= to name the level dimension')
        das = {k: dat[k] for k in names}
    else:
        # The names= contract holds for plain dicts too.
        das = (dict(dat) if names is None
               else {k: dat[k] for k in names})
    args = list(das.values())
    batch_dims = _batch_dims_of(args, vert_dim)
    keys = list(das)
    low = _lower_common(args, vert_dim, batch_dims)
    fields = dict(zip(keys, low))
    vc = _vert_coord_of(args, vert_dim)
    coords = _coords_of(args, batch_dims)
    if _is_dataset(dat):
        # Dataset-level coords (xr_lite keeps them only on the Dataset).
        ds_coords = getattr(dat, 'coords', {})
        if vc is None and vert_dim in ds_coords:
            c = ds_coords[vert_dim]
            vc = np.asarray(c.values if hasattr(c, 'values') else c)
        for d in batch_dims:
            if d not in coords and d in ds_coords:
                coords[d] = ds_coords[d]
    return fields, batch_dims, vc, coords


def get_layer(dat, depth=100.0, interpolate=True,
              vert_dim=DEFAULT_VERT_DIM, names=None):
    """Surface-based layer of the given pressure depth; with ``interpolate``
    the layer top is added as a new level (L+1 output)
    (reference: modules/parcel_functions.py:63-100).
    ``names``: variables to include (default: all carrying ``vert_dim``)."""
    fields, batch_dims, vc, coords = _fields_of(dat, vert_dim, names=names)
    run = _jitted(_ops.get_layer, (('depth', float(depth)),
                                   ('interpolate', bool(interpolate))))
    return _lift(run(fields), batch_dims, vert_dim=vert_dim, coords=coords,
                 vert_coord=vc)


def mixed_layer(dat, depth=100.0, vert_dim=DEFAULT_VERT_DIM, names=None):
    """Mass-weighted layer means of every non-pressure level variable
    (reference: modules/parcel_functions.py:137-162).
    ``names``: variables to include (default: all carrying ``vert_dim``)."""
    fields, batch_dims, _, coords = _fields_of(dat, vert_dim, names=names)
    run = _jitted(_parcels.mixed_layer, (('depth', float(depth)),))
    return _lift(run(fields), batch_dims, coords=coords)


def mixed_parcel(pressure, temperature, dewpoint, depth=100.0,
                 vert_dim=DEFAULT_VERT_DIM):
    """Fully-mixed surface-layer parcel state
    (reference: modules/parcel_functions.py:229-289)."""
    args = (pressure, temperature, dewpoint)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_parcels.mixed_parcel, (('depth', float(depth)),))
    return _lift(run(*low), batch_dims, coords=_coords_of(args, batch_dims))


def most_unstable_parcel(pressure, temperature, dewpoint, depth=300.0,
                         vert_dim=DEFAULT_VERT_DIM):
    """The max-theta-e parcel in the surface layer
    (reference: modules/parcel_functions.py:102-135)."""
    args = (pressure, temperature, dewpoint)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_parcels.most_unstable_parcel, (('depth', float(depth)),))
    return _lift(run(*low), batch_dims, coords=_coords_of(args, batch_dims))


def insert_level(dat, level, coord='pressure', vert_dim=DEFAULT_VERT_DIM,
                 names=None):
    """Splice a per-column level into pressure-sorted profiles; the output
    has L+1 levels and keeps a vertical index coordinate exactly as the
    reference's reindexing does
    (reference: modules/parcel_functions.py:933-990).
    ``names``: variables to include (default: all carrying ``vert_dim``)."""
    fields, batch_dims, vc, coords = _fields_of(dat, vert_dim, names=names)
    lvl = {k: _lower(v, None, batch_dims) for k, v in
           (level.data_vars.items() if _is_dataset(level)
            else dict(level).items())}
    run = _jitted(_ops.insert_level, (('coord', coord),))
    return _lift(run(fields, lvl), batch_dims, vert_dim=vert_dim,
                 coords=coords, vert_coord=vc)


def find_intersections(x, a, b, log_x=False, vert_dim=DEFAULT_VERT_DIM):
    """Crossings of two curves sharing coordinates; entry k describes the
    crossing in gap (k, k+1), NaN where none
    (reference: modules/parcel_functions.py:992-1064)."""
    args = (x, a, b)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_ops.find_intersections, (('log_x', bool(log_x)),))
    out = {k: v for k, v in run(*low).items() if k != 'all_logx'}
    return _lift(out, batch_dims, vert_dim=vert_dim, coords=_coords_of(
        args, batch_dims))


def trapz(y, x, vert_dim=DEFAULT_VERT_DIM):
    """NaN-skipping trapezoidal integral along the vertical dim
    (reference: modules/parcel_functions.py:164-206)."""
    args = (y, x)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    return _lift_da(_jitted(_ops.trapz)(*low), batch_dims,
                    coords=_coords_of(args, batch_dims), name='trapz')


def linear_interp(x, coords, at, extrapolate=False,
                  vert_dim=DEFAULT_VERT_DIM):
    """Duplicate-aware linear interpolation at a per-column target
    (reference: modules/parcel_functions.py:1758-1811)."""
    args = (x, coords, at)
    batch_dims = _batch_dims_of(args[:2], vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_ops.linear_interp, (('extrapolate', bool(extrapolate)),))
    return _lift_da(run(*low), batch_dims,
                    coords=_coords_of(args, batch_dims), name=None)


def log_interp(x, coords, at, extrapolate=False, vert_dim=DEFAULT_VERT_DIM):
    """``linear_interp`` on log-transformed coordinates
    (reference: modules/parcel_functions.py:1813-1828)."""
    args = (x, coords, at)
    batch_dims = _batch_dims_of(args[:2], vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_ops.log_interp, (('extrapolate', bool(extrapolate)),))
    return _lift_da(run(*low), batch_dims,
                    coords=_coords_of(args, batch_dims), name=None)


def shift_out_nans(dat, key='pressure', vert_dim=DEFAULT_VERT_DIM,
                   names=None):
    """Shift columns left over their leading NaNs (the reference's
    compaction loop; parity surface — the production pipelines use
    first-valid-index semantics instead)
    (reference: modules/parcel_functions.py:1699-1720).
    ``names``: variables to include (default: all carrying ``vert_dim``)."""
    fields, batch_dims, vc, coords = _fields_of(dat, vert_dim, names=names)
    run = _jitted(_ops.compact_left, (('key', key),))
    return _lift(run(fields), batch_dims, vert_dim=vert_dim, coords=coords,
                 vert_coord=vc)


def bound_pressure(pressure, bound, vert_dim=DEFAULT_VERT_DIM):
    """Closest pressure level to ``bound``; ties take the larger pressure
    (reference: modules/parcel_functions.py:208-227)."""
    args = (pressure, bound)
    batch_dims = _batch_dims_of((pressure,), vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    return _lift_da(_jitted(_ops.bound_pressure)(*low), batch_dims,
                    coords=_coords_of(args, batch_dims),
                    name='bound_pressure')


def trap_around_zeros(x, y, log_x=True, start=0,
                      vert_dim=DEFAULT_VERT_DIM):
    """Rectangle areas hugging each zero crossing of ``y`` along ``x``;
    returns (areas Dataset over a fresh gap index, gap-mask DataArray)
    (reference: modules/parcel_functions.py:1200-1273)."""
    args = (x, y)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_ops.trap_around_zeros, (('log_x', bool(log_x)),
                                           ('start', int(start))))
    areas, gap_mask = run(*low)
    coords = _coords_of(args, batch_dims)
    return (_lift(areas, batch_dims, vert_dim=vert_dim, coords=coords),
            _lift_da(gap_mask, batch_dims, coords=coords, name='gap_mask',
                     vert_dim=vert_dim))


def cape_cin_base(pressure, temperature, lfc_pressure, el_pressure,
                  parcel_temperature, vert_dim=DEFAULT_VERT_DIM,
                  pos_cape_neg_cin=True, post_zero_cin=False):
    """CAPE/CIN from a parcel track and LFC/EL pressures
    (reference: modules/parcel_functions.py:1291-1392)."""
    args = (pressure, temperature, lfc_pressure, el_pressure,
            parcel_temperature)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_cape.cape_cin_base,
                  (('pos_cape_neg_cin', bool(pos_cape_neg_cin)),
                   ('post_zero_cin', bool(post_zero_cin))))
    return _lift(run(*low), batch_dims,
                 coords=_coords_of(args, batch_dims))


def add_lcl_to_profile(profile, environment=None, interpolator='log',
                       vert_dim=DEFAULT_VERT_DIM):
    """Splice the profile's LCL into its level tracks (L+1 output),
    optionally interpolating environment tracks at the LCL
    (reference: modules/parcel_functions.py:858-931)."""
    prof_fields, batch_dims, vc, coords = _fields_of(
        profile, vert_dim,
        names=list(profile.data_vars) if _is_dataset(profile)
        else list(dict(profile)))
    env_fields = None
    if environment is not None:
        env_fields, _, _, _ = _fields_of(
            environment, vert_dim,
            names=list(environment.data_vars) if _is_dataset(environment)
            else list(dict(environment)))
    run = _jitted(_profile.add_lcl_to_profile,
                  (('interpolator', interpolator),))
    out = run(prof_fields, environment=env_fields)
    return _lift(out, batch_dims, vert_dim=vert_dim, coords=coords,
                 vert_coord=vc)


def from_most_unstable_parcel(pressure, temperature, dewpoint, depth=300.0,
                              vert_dim=DEFAULT_VERT_DIM):
    """Columns masked to levels at/above the most unstable parcel, plus the
    parcel; returns (fields Dataset, parcel Dataset)
    (reference: modules/parcel_functions.py:1517-1555)."""
    args = (pressure, temperature, dewpoint)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_parcels.from_most_unstable_parcel,
                  (('depth', float(depth)),))
    fields, parcel = run(*low)
    coords = _coords_of(args, batch_dims)
    vc = _vert_coord_of(args, vert_dim)
    return (_lift(fields, batch_dims, vert_dim=vert_dim, coords=coords,
                  vert_coord=vc),
            _lift(parcel, batch_dims, coords=coords))


def mix_layer(pressure, temperature, dewpoint, depth=100.0,
              vert_dim=DEFAULT_VERT_DIM):
    """Columns with the lowest ``depth`` hPa replaced by the fully-mixed
    parcel as a spliced bottom level (L+1 output); returns
    (fields Dataset, parcel Dataset)
    (reference: modules/parcel_functions.py:1604-1649)."""
    args = (pressure, temperature, dewpoint)
    batch_dims = _batch_dims_of(args, vert_dim)
    low = _lower_common(args, vert_dim, batch_dims)
    run = _jitted(_parcels.mix_layer, (('depth', float(depth)),))
    fields, parcel = run(*low)
    coords = _coords_of(args, batch_dims)
    vc = _vert_coord_of(args, vert_dim)
    return (_lift(fields, batch_dims, vert_dim=vert_dim, coords=coords,
                  vert_coord=vc),
            _lift(parcel, batch_dims, coords=coords))


# Table/builder utilities under the reference's names (array-level; no
# Dataset boundary involved — re-exported so every reference def resolves
# on this surface too; reference: modules/parcel_functions.py:39-61,
# :318-362, :447-523).
from .api import (interp1d_numba, lookup_tables_loaded,  # noqa: E402,F401
                  moist_adiabat_lookup, moist_adiabat_tables, round_to)
