"""AOT deployment: export a compiled pipeline once, serve it anywhere.

The reference has no serving story — every session re-builds and
re-schedules its lazy dask graph before any data moves (reference:
modules/parcel_functions.py:561-579 re-chunks per call; the demo notebook
re-runs the full pipeline per session).  The JAX equivalent of that cost
is concrete: every distinct XLA program pays Python tracing + lowering +
backend compilation before its first batch (tens of seconds for a whole
pipeline).  This module removes all three from the serving process:

- :func:`export_pipeline` AOT-traces and lowers a pipeline to a
  serialized StableHLO artifact (zip of the ``jax.export`` blob + JSON
  metadata).  Every registry pipeline reads ONLY the ~2-5 MB spectral
  coefficients at runtime (the 300 MB curves/lookup arrays are build-time
  inputs: the fused solve evaluates piecewise-Chebyshev rows
  (``adiabat.blend_coeff_rows``), and curve indexing integrates the ODE
  backwards, ``adiabat.curve_index_integrate``), so by default the
  export is *slim*:
  the coefficients are embedded in the artifact and the serving process
  needs NO table cache, NO table build, and no ``tables=`` argument at
  all — the zip is the whole deployment.  A pipeline that genuinely
  gathers from the full tables (``index_mode='bilinear'``/``'nearest'``,
  pointwise ``moist_lapse``) is detected by dead-code-eliminating the
  traced program and automatically falls back to the full-table artifact,
  where tables stay runtime arguments (~100 kB zip + the table cache at
  serve time).
- :func:`load` returns a :class:`Deployed` callable.  Fixed-batch
  artifacts serve ANY grid size: inputs pad up to the exported batch
  (NaN for floats — the pipelines' NaN contract turns padded rows into
  NaN outputs), run chunk-by-chunk, and slice back (same contract as
  ``parallel.chunked``).  ``polymorphic=True`` artifacts embed a symbolic
  batch dimension instead and run any size directly.
- :func:`enable_compilation_cache` turns on JAX's persistent compile
  cache, so even the backend-compile step is paid once per machine
  rather than once per process.

An artifact serves on the platforms it was lowered for (recorded in its
metadata; by default the exporting process's backend).  Pass
``platforms=('cpu', 'cuda')`` for a multi-platform artifact.
"""

import io
import json
import os
import zipfile

import numpy as np

import jax
import jax.numpy as jnp

from . import adiabat, pipeline

_FORMAT = 'xarray-parcel-tpu-exported-v1'
#: Slim artifacts (embedded coefficient table, 1-leaf table argument) are
#: written as v2 so a pre-slim loader fails fast on the format check
#: instead of feeding a 3-leaf table tuple to a 1-leaf program.
_FORMAT_SLIM = 'xarray-parcel-tpu-exported-v2'
_FORMATS_READ = frozenset({_FORMAT, _FORMAT_SLIM})

def _with_proxies(base):
    def fn(dat, tables=None, **kwargs):
        out = dict(base(dat, tables=tables, **kwargs))
        out.update(pipeline.storm_proxies(out))
        return out
    fn.__name__ = base.__name__ + '_with_proxies'
    return fn


#: Exportable named pipelines (dict-in / dict-out, ``tables=`` kwarg).
#: The ``_with_proxies`` forms append the 8 storm-proxy booleans + SHIP,
#: the reference demo's full output set (parcel_functions.py:2323-2407).
PIPELINES = {
    'conv_properties': pipeline.conv_properties,
    'conv_properties_fused': pipeline.conv_properties_fused,
    'min_conv_properties': pipeline.min_conv_properties,
    'min_conv_properties_fused': pipeline.min_conv_properties_fused,
    'conv_properties_with_proxies': _with_proxies(pipeline.conv_properties),
    'conv_properties_fused_with_proxies':
        _with_proxies(pipeline.conv_properties_fused),
}


def input_spec(batch, levels=90, wind_levels=None, dtype=jnp.float32):
    """ShapeDtypeStruct dict for the pipelines' input contract
    (reference variable names, modules/parcel_functions.py:1951-2100).

    ``batch`` may be an int or a symbolic dimension from
    ``jax.export.symbolic_shape``.
    """
    lw = levels if wind_levels is None else wind_levels
    s = lambda *shape: jax.ShapeDtypeStruct(shape, dtype)
    return {
        'pressure': s(batch, levels),
        'temperature': s(batch, levels),
        'specific_humidity': s(batch, levels),
        'height_asl': s(batch, levels),
        'surface_wind_u': s(batch),
        'surface_wind_v': s(batch),
        'wind_u': s(batch, lw),
        'wind_v': s(batch, lw),
        'wind_height_above_surface': s(batch, lw),
    }


def _tables_or_load(tables, dtype=None):
    """Default tables, auto-building/loading the cache in a fresh serving
    process (the load-first guard stays for the library surfaces).

    ``dtype`` is the table dtype the artifact was exported with: the
    serving process's own config (e.g. ``jax_enable_x64``) must not pick
    the cache flavour, or a cross-configuration serve fails the exported
    signature check.
    """
    if tables is not None:
        return tables
    try:
        tables = adiabat.default_tables()
    except RuntimeError:
        tables = None
    if tables is None or (dtype is not None and
                          np.dtype(tables.curves.dtype) != np.dtype(dtype)):
        tables = adiabat.load_moist_adiabat_lookups(dtype=dtype)
    return tables


_TABLE_NAMES = ('curves', 'lookup', 'coeffs')


def _used_tables(fn, dat_spec, tab_spec, kwargs):
    """Which of the three table arrays the pipeline actually READS.

    Traces the pipeline abstractly (no compile, no device work) and
    dead-code-eliminates the jaxpr; the DCE's used-inputs mask on the
    three table leaves is the slim-export eligibility test.  A plain
    "does the var appear in an equation" scan would false-positive on
    dead equations; DCE does not.
    """
    def probe(dat, table_arrays):
        return dict(fn(dat, tables=adiabat.AdiabatTables(*table_arrays),
                       **kwargs))

    from jax.interpreters import partial_eval as pe
    closed = jax.make_jaxpr(probe)(dat_spec, tab_spec)
    n_dat = len(jax.tree_util.tree_leaves(dat_spec))
    _, used = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    return {n for n, f in zip(_TABLE_NAMES, used[n_dat:n_dat + 3]) if f}


def export_pipeline(name, batch, levels=90, wind_levels=None,
                    dtype=jnp.float32, tables=None, polymorphic=False,
                    platforms=None, mesh=None, path=None, slim=None,
                    **kwargs):
    """AOT-export a named pipeline (or any dict->dict callable taking a
    ``tables=`` kwarg) at a static input shape; returns a :class:`Deployed`.

    ``batch`` is the exported static batch size; a fixed-batch artifact
    still serves any grid (see :class:`Deployed`).  ``polymorphic=True``
    exports a symbolic batch dimension instead.  ``mesh`` exports the
    SPMD program instead: the batch dim sharded over the mesh
    (``parallel.batch_spec`` layout), tables replicated — one artifact
    drives every card of the mesh; serving needs a mesh
    of the same device count (see :meth:`Deployed.__call__`).  ``kwargs``
    are closed over (they become part of the compiled program, e.g.
    ``ignore_nans=True``).  ``tables`` defaults to the cached table
    build.

    ``slim`` controls whether the ~2-5 MB spectral coefficients are
    embedded so the artifact is fully standalone (see the module
    docstring).  Default ``None`` = auto: slim whenever the pipeline
    reads only ``tables.coeffs`` (true for every registry pipeline),
    full-table otherwise.  ``True`` forces slim and raises if the
    pipeline reads the curves/lookup arrays; ``False`` forces the
    full-table artifact (tables stay runtime arguments; only their
    shapes/dtypes enter the artifact).
    """
    fn = PIPELINES[name] if isinstance(name, str) else name
    fn_name = name if isinstance(name, str) else getattr(
        name, '__name__', 'custom')
    if polymorphic and mesh is not None:
        raise ValueError('polymorphic batch and mesh sharding do not '
                         'compose — export a fixed sharded batch')
    tables = _tables_or_load(tables)

    if slim is None or slim:
        if getattr(tables, 'coeffs', None) is None:
            # coeffs=None is a legal AdiabatTables state (adiabat.py:397);
            # slim needs them, the full-table export below does not.
            if slim:
                raise ValueError(
                    'slim=True needs spectral coefficients but '
                    'tables.coeffs is None — rebuild with '
                    'load_moist_adiabat_lookups()')
            big = ['coeffs is None — rebuild the tables']
        else:
            full_tab_spec = tuple(
                jax.ShapeDtypeStruct(np.shape(a), np.dtype(a.dtype))
                for a in (tables.curves, tables.lookup, tables.coeffs))
            # Eligibility probe at a small concrete batch (table usage is
            # batch-independent; no compile, no device work).
            try:
                used = _used_tables(
                    fn, input_spec(8, levels=levels,
                                   wind_levels=wind_levels, dtype=dtype),
                    full_tab_spec, kwargs)
                big = sorted(used & {'curves', 'lookup'})
            except Exception:
                if slim:
                    raise
                big = ['<usage probe failed>']
            if big and slim:
                raise ValueError(
                    'slim=True needs a coefficients-only pipeline, but '
                    f'this one reads the full table arrays {big} (e.g. '
                    "index_mode='bilinear'/'nearest' or pointwise "
                    'moist_lapse) — export with slim=False')
        slim = not big

    if slim:
        # Embed the coefficients.  Curves/lookup become zero-filled
        # trace-time placeholders at the ORIGINAL shapes/dtypes: the probe
        # proved their DATA is never read, and full-shape placeholders
        # keep trace-time shape/dtype consultation (e.g. a custom
        # pipeline branching on tables.lookup.shape) faithful instead of
        # silently seeing (0, 0).  Unconsumed, they cost one scalar
        # broadcast in the StableHLO that XLA dead-code-eliminates.
        coeffs_host = np.asarray(tables.coeffs)
        curves_sds = jax.ShapeDtypeStruct(np.shape(tables.curves),
                                          np.dtype(tables.curves.dtype))
        lookup_sds = jax.ShapeDtypeStruct(np.shape(tables.lookup),
                                          np.dtype(tables.lookup.dtype))

        def wrapper(dat, table_arrays):
            coeffs, = table_arrays
            tab = adiabat.AdiabatTables(
                jnp.zeros(curves_sds.shape, curves_sds.dtype),
                jnp.zeros(lookup_sds.shape, lookup_sds.dtype),
                coeffs)
            return dict(fn(dat, tables=tab, **kwargs))

        tab_arrays = (coeffs_host,)
    else:
        # Full-table artifact: the tables are runtime arguments.  A
        # spectral-less build (coeffs=None) exports a 2-leaf program
        # (AdiabatTables' coeffs argument defaults to None).
        n_tab = 2 if tables.coeffs is None else 3

        def wrapper(dat, table_arrays):
            tab = adiabat.AdiabatTables(*table_arrays)
            return dict(fn(dat, tables=tab, **kwargs))

        tab_arrays = (tables.curves, tables.lookup, tables.coeffs)[:n_tab]

    if polymorphic:
        batch_dim, = jax.export.symbolic_shape('b')
    elif batch is None:
        raise ValueError('batch=None needs polymorphic=True (or pass the '
                         'static batch size to export)')
    elif int(batch) < 1:
        raise ValueError(f'exported batch must be >= 1, got {batch}')
    else:
        batch_dim = int(batch)
    # batch_spec shards the batch over the FIRST mesh axis only.
    if mesh is not None and int(batch) % int(mesh.devices.shape[0]):
        raise ValueError(f'batch {batch} must divide evenly over the '
                         f'{int(mesh.devices.shape[0])}-way batch axis of '
                         'the mesh (Deployed pads any real grid onto it)')
    dat_spec = input_spec(batch_dim, levels=levels, wind_levels=wind_levels,
                          dtype=dtype)
    # shape/dtype only — never materialize or device-place a (possibly
    # host-resident, ~200 MB) table just to read its metadata.
    tab_spec = tuple(
        jax.ShapeDtypeStruct(np.shape(a), np.dtype(a.dtype))
        for a in tab_arrays)
    if mesh is not None:
        from .parallel import batch_spec, replicated
        from jax.sharding import NamedSharding
        dat_spec = {k: jax.ShapeDtypeStruct(
            s.shape, s.dtype,
            sharding=NamedSharding(mesh, batch_spec(mesh, len(s.shape))))
            for k, s in dat_spec.items()}
        tab_spec = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                           sharding=replicated(mesh)),
            tab_spec)

    if not jax.config.jax_enable_x64:
        f64 = sorted({np.dtype(s.dtype).name
                      for s in jax.tree_util.tree_leaves((dat_spec,
                                                          tab_spec))
                      if np.dtype(s.dtype).kind == 'f'
                      and np.dtype(s.dtype).itemsize == 8})
        if f64:
            raise ValueError(
                'float64 export requires x64: jax.export would silently '
                f'canonicalize {f64} to float32 while the artifact '
                'metadata claims float64 — call '
                "jax.config.update('jax_enable_x64', True) first "
                '(the CLI does this automatically)')

    exp = jax.export.export(
        jax.jit(wrapper),
        platforms=list(platforms) if platforms else None,
    )(dat_spec, tab_spec)

    meta = {
        # v2 = any artifact whose table argument is NOT the classic
        # 3-leaf tuple (slim's 1 leaf, spectral-less 2 leaves): a
        # pre-slim loader would feed it 3 leaves and die on an opaque
        # arity mismatch, so those must fail its format check instead.
        'format': _FORMAT if len(tab_arrays) == 3 else _FORMAT_SLIM,
        'pipeline': fn_name,
        'batch': None if polymorphic else int(batch),
        'polymorphic': bool(polymorphic),
        'levels': int(levels),
        'wind_levels': int(levels if wind_levels is None else wind_levels),
        'dtype': np.dtype(dtype).name,
        'slim': bool(slim),
        'table_dtype': np.dtype(tables.curves.dtype).name,
        'table_dtypes': [np.dtype(a.dtype).name for a in tab_arrays],
        'platforms': list(exp.platforms),
        'mesh': None if mesh is None else {
            'axis_names': list(mesh.axis_names),
            'shape': [int(s) for s in mesh.devices.shape]},
        'kwargs': {k: repr(v) for k, v in kwargs.items()},
        'jax_version': jax.__version__,
    }
    deployed = Deployed(exp, meta,
                        embedded=(coeffs_host,) if slim else None)
    if path is not None:
        deployed.save(path)
    return deployed


class Deployed:
    """A loaded/exported pipeline artifact: ``deployed(dat)`` runs it.

    Fixed-batch artifacts accept any leading batch size: inputs pad up to
    a multiple of the exported batch (NaN for floats, zero otherwise) and
    run chunk-by-chunk; padded rows are sliced off the outputs.
    """

    def __init__(self, exported, meta, embedded=None):
        self.exported = exported
        self.meta = dict(meta)
        self._embedded = embedded     # (coeffs,) for slim artifacts
        self._placed = {}             # (id(tables), id(mesh)) -> placement
        self._default_mesh = None
        if self.meta.get('slim') and embedded is None:
            raise ValueError('slim artifact without its embedded '
                             'coefficients — load() it from the zip')

    def save(self, path):
        """Write the artifact (zip of StableHLO blob + JSON metadata;
        slim artifacts also carry their embedded coefficient table)."""
        with zipfile.ZipFile(path, 'w', zipfile.ZIP_DEFLATED) as z:
            z.writestr('meta.json', json.dumps(self.meta, indent=1))
            z.writestr('exported.stablehlo', self.exported.serialize())
            if self._embedded is not None:
                bio = io.BytesIO()
                np.savez(bio, coeffs=np.asarray(self._embedded[0]))
                z.writestr('tables.npz', bio.getvalue())
        return path

    def _mesh(self, mesh):
        """Resolve the serving mesh for a sharded artifact (or None)."""
        want = self.meta.get('mesh')
        if want is None:
            if mesh is not None:
                raise ValueError(
                    'this artifact was not exported with mesh= — the '
                    'passed serving mesh would be silently ignored; '
                    're-export with export_pipeline(..., mesh=mesh) for '
                    'SPMD serving')
            return None
        shape = tuple(want['shape'])
        if mesh is None:
            if self._default_mesh is not None:
                return self._default_mesh
            n = int(np.prod(shape))
            avail = len(jax.devices())
            if avail != n:
                raise ValueError(f'artifact was exported for {n} devices; '
                                 f'{avail} available — pass a matching '
                                 'mesh= or re-export')
            from .parallel import make_mesh
            mesh = make_mesh(axis_names=tuple(want['axis_names']),
                             shape=shape)
            self._default_mesh = mesh
        # The exported HloShardings are positional: the batch dim is laid
        # out over the FIRST mesh axis, so the serving mesh must reproduce
        # the exported axis shape, not just the device count.
        if tuple(int(s) for s in mesh.devices.shape) != shape:
            raise ValueError(f'artifact was exported on a mesh of shape '
                             f'{shape}; serving mesh has shape '
                             f'{tuple(mesh.devices.shape)}')
        return mesh

    def _place_tables(self, tables, mesh):
        """Device placement of the artifact's table arguments (the full
        ~200 MB tables, or just the embedded coefficients for slim
        artifacts), memoized per (tables, mesh) pair — serving loops must
        not re-transfer them on every call.  The value tuple pins both
        keys' referents so a recycled ``id()`` can never alias a dead
        entry."""
        if self.meta.get('slim') and tables is None:
            tables = self          # the embedded coefficients ARE the key
        key = (id(tables), None if mesh is None else id(mesh))
        memo = self._placed.get(key)
        if memo is not None and memo[0] is tables and memo[1] is mesh:
            self._placed.pop(key)        # re-insert: LRU recency
            self._placed[key] = memo
            return memo[2]
        if self.meta.get('slim'):
            if tables is self:
                raw = (self._embedded[0],)
            else:
                c = getattr(tables, 'coeffs', tables)
                if c is None:
                    raise ValueError(
                        'this slim artifact needs spectral coefficients '
                        'but tables.coeffs is None — pass tables=None to '
                        'use the embedded ones')
                raw = (c,)
        else:
            # Spectral-less exports carry 2 table leaves (coeffs=None).
            n_tab = len(self.meta.get('table_dtypes') or ()) or 3
            raw = (tables.curves, tables.lookup, tables.coeffs)[:n_tab]
            if n_tab == 3 and raw[2] is None:
                raise ValueError(
                    'this artifact was exported with spectral '
                    'coefficients but the serving tables have '
                    'coeffs=None — rebuild with '
                    'load_moist_adiabat_lookups()')
        arrs = tuple(t if hasattr(t, 'ndim') else np.asarray(t)
                     for t in raw)
        # Coerce each array to its exported dtype (curves/lookup/coeffs can
        # legitimately differ — a downcast table keeps its wider lookup).
        # A no-op when they match; the rare mismatch cast is memoized.
        want = self.meta.get('table_dtypes')
        if want:
            arrs = tuple(a if np.dtype(a.dtype) == np.dtype(w)
                         else a.astype(np.dtype(w))
                         for a, w in zip(arrs, want))
        if mesh is not None:
            from .parallel import replicate
            # replicate (not raw device_put): multi-process consistency
            # checks NaN-bearing tables elementwise, and a plain
            # jnp.asarray would double-place via the default device
            # (parallel/mesh.py:_put_global).
            tab = replicate(arrs, mesh)
        else:
            tab = tuple(jnp.asarray(a) for a in arrs)
        self._placed[key] = (tables, mesh, tab)
        # Bounded LRU: a serving loop that constructs fresh tables (or a
        # fresh mesh) per call must not pin every dead ~200 MB pair and
        # its device placement forever.
        while len(self._placed) > 4:
            self._placed.pop(next(iter(self._placed)))
        return tab

    def check_inputs(self, dat):
        """Split ``dat`` against the exported input contract.

        Returns ``(kept, missing, extra)``: the recognized variables, the
        required names absent from ``dat``, and the unrecognized names
        that were dropped.  The single source of truth for input
        validation on every serving surface (CLI, ``xarray_api.serve``)
        — callers fail on ``missing`` with a clear message instead of
        jax.export's treedef mismatch.
        """
        expected = set(input_spec(1, levels=self.meta['levels'],
                                  wind_levels=self.meta['wind_levels']))
        missing = sorted(expected - set(dat))
        extra = sorted(set(dat) - expected)
        kept = {k: v for k, v in dat.items() if k in expected}
        return kept, missing, extra

    @staticmethod
    def _host(out):
        """Materialize a served output pytree host-side.  On one process,
        plain ``np.asarray``; across processes the chunk outputs are
        global arrays spanning non-addressable devices, so gather them
        (each process gets the full value, as for the inputs)."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            return multihost_utils.process_allgather(out, tiled=True)
        return jax.tree_util.tree_map(np.asarray, out)

    def __call__(self, dat, tables=None, mesh=None):
        """Serve one batch.  Exact-fit and polymorphic calls return device
        arrays; the pad/chunk path returns host numpy arrays (outputs are
        materialized chunk-by-chunk)."""
        if not dat:
            raise ValueError('empty input dict — nothing to serve')
        dat, missing, extra = self.check_inputs(dat)
        if missing or extra:
            # Fail on NAMES here, the lowest serving surface, so a typo'd
            # key reads as "missing X / unrecognized Y" rather than
            # jax.export's opaque treedef mismatch.  Callers that want to
            # drop extras silently (CLI, xarray_api.serve) pre-filter via
            # check_inputs.
            raise ValueError(
                f'input does not match the exported contract: '
                f'missing {missing or "nothing"}, '
                f'unrecognized {extra or "nothing"}')
        bad = sorted(k for k, v in dat.items() if not np.shape(v))
        if bad:
            raise ValueError('inputs must carry a leading batch dim; '
                             f'0-d fields: {bad}')
        sizes = {np.shape(v)[0] for v in dat.values()}
        if len(sizes) != 1:
            raise ValueError(f'mixed leading batch dims: {sorted(sizes)}')
        b = sizes.pop()
        if b == 0:
            raise ValueError('empty batch (leading dim 0) — nothing to '
                             'serve')
        # Trailing extents must match the exported contract too — fail
        # here with the variable named, not in jax.export's aval error.
        spec = input_spec(1, levels=self.meta['levels'],
                          wind_levels=self.meta['wind_levels'])
        wrong = {k: (tuple(np.shape(v)[1:]), tuple(spec[k].shape[1:]))
                 for k, v in dat.items()
                 if tuple(np.shape(v)[1:]) != tuple(spec[k].shape[1:])}
        if wrong:
            raise ValueError(
                'input extents beyond the batch dim do not match the '
                'exported contract (got vs exported): ' + ', '.join(
                    f'{k}: {g} vs {w}'
                    for k, (g, w) in sorted(wrong.items())))
        # Coerce float dtypes like the CLI and xarray_api.serve do, so
        # all three surfaces accept default-dtype numpy inputs.  Cast on
        # the host: an eager device astype would dispatch a program per
        # input.  Matching dtypes (incl. device arrays) pass through
        # untouched.
        want = np.dtype(self.meta.get('dtype', 'float32'))

        def _coerce(v):
            dt = getattr(v, 'dtype', None)
            dt = np.dtype(dt) if dt is not None else np.asarray(v).dtype
            if dt.kind == 'f' and dt != want:
                return np.asarray(v).astype(want, copy=False)
            return v

        dat = {k: _coerce(v) for k, v in dat.items()}

        if not self.meta.get('slim'):
            # Slim artifacts carry their coefficients; only full-table
            # artifacts auto-load the cache in a fresh serving process.
            tables = _tables_or_load(tables,
                                     dtype=self.meta.get('table_dtype'))
        mesh = self._mesh(mesh)
        tab = self._place_tables(tables, mesh)
        if mesh is not None:
            from .parallel import shard_batch
            place = lambda d: shard_batch(d, mesh)
        else:
            place = lambda d: d

        bex = self.meta.get('batch')
        if bex is None:                       # polymorphic artifact
            return self.exported.call(
                {k: jnp.asarray(v) for k, v in dat.items()}, tab)
        if b == bex:                          # exact fit: no copies at all
            return self.exported.call(place(dat), tab)

        # Mismatched batch: pad/slice on the HOST (numpy views are free
        # and the exported call stages each chunk to the device anyway —
        # eager device pad/slice programs would each cost a compile).
        # Device-resident inputs take one transfer here; outputs come
        # back as host arrays.  The loop keeps one chunk in flight while
        # the previous chunk's outputs read back, so D2H overlaps compute
        # instead of serializing against it.
        from .parallel.chunked import pad_fill
        dat = {k: np.asarray(v) for k, v in dat.items()}
        pad = (-b) % bex
        if pad:
            dat = {k: np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1),
                             constant_values=pad_fill(v.dtype))
                   for k, v in dat.items()}
        chunks, pending = [], None
        for i in range((b + pad) // bex):
            sl = {k: v[i * bex:(i + 1) * bex] for k, v in dat.items()}
            out = self.exported.call(place(sl), tab)
            if pending is not None:
                chunks.append(self._host(pending))
            pending = out
        chunks.append(self._host(pending))
        return jax.tree_util.tree_map(
            lambda *xs: np.concatenate(xs, axis=0)[:b], *chunks)


def _read_meta(path):
    """Artifact metadata alone — no StableHLO deserialization; friendly
    errors for non-zip files and zips that are not artifacts."""
    try:
        with zipfile.ZipFile(path) as z:
            return json.loads(z.read('meta.json'))
    except (KeyError, zipfile.BadZipFile) as e:
        raise ValueError(
            'not an xarray-parcel-tpu exported artifact (expected a zip '
            f'containing meta.json + exported.stablehlo): {path}') from e


def load(path):
    """Load a :class:`Deployed` artifact written by :meth:`Deployed.save`."""
    meta = _read_meta(path)
    if meta.get('format') not in _FORMATS_READ:
        raise ValueError(
            f'not an xarray-parcel-tpu exported artifact '
            f'(readable formats: {sorted(_FORMATS_READ)}, got '
            f'{meta.get("format")!r}): {path}')
    with zipfile.ZipFile(path) as z:
        exported = jax.export.deserialize(z.read('exported.stablehlo'))
        embedded = None
        if meta.get('slim'):
            with np.load(io.BytesIO(z.read('tables.npz'))) as d:
                embedded = (d['coeffs'],)
    return Deployed(exported, meta, embedded=embedded)


def _parse_mesh_spec(spec):
    """'8' -> (8,); '4x2' -> (4, 2) — SystemExit on anything else."""
    try:
        shape = tuple(int(s) for s in spec.lower().split('x'))
    except ValueError:
        raise SystemExit(f"--mesh {spec!r}: expected e.g. '8' or "
                         "'4x2'") from None
    if not shape or any(s < 1 for s in shape):
        raise SystemExit(f'--mesh {spec!r}: axis sizes must be positive')
    return shape


def _build_cli_mesh(shape, names):
    """Mesh of the given axis shape/names from the first N local devices."""
    n = int(np.prod(shape))
    devices = jax.devices()
    if len(devices) < n:
        raise SystemExit(f'mesh shape {shape} needs {n} devices; '
                         f'{len(devices)} available')
    from .parallel import make_mesh
    return make_mesh(devices[:n], axis_names=names, shape=shape)


def _cli_export(args):
    slim = {'auto': None, 'true': True, 'false': False}[args.slim]
    if np.dtype(args.dtype).itemsize == 8:
        # Without x64, JAX canonicalizes f64 to f32 and the export would
        # silently produce a float32 artifact.
        jax.config.update('jax_enable_x64', True)
    tables = None
    if args.tables:
        # Sniff the RAW npz dtypes before constructing AdiabatTables:
        # with x64 still off, construction canonicalizes f64 arrays to
        # f32, so a post-construction dtype check can never fire.
        with np.load(args.tables) as f:
            arrays = {k: np.asarray(f[k]) for k in f.files}
        if any(a.dtype.itemsize == 8 for a in arrays.values()
               if a.dtype.kind == 'f'):
            jax.config.update('jax_enable_x64', True)
        # Host-backed tables: export only reads shapes/dtypes (and a host
        # copy of coeffs for slim), so never device-place the ~200 MB
        # curves/lookup (_from_arrays would, via jnp.asarray).
        # Stale/missing coefficients rebuild exactly as _from_arrays does.
        coeffs = arrays.get('coeffs')
        if coeffs is not None and np.shape(coeffs)[-1] != adiabat.N_COEF:
            coeffs = None
        if coeffs is None:
            coeffs = np.asarray(adiabat.build_spectral(
                dtype=arrays['curves'].dtype))
        tables = adiabat.AdiabatTables(arrays['curves'], arrays['lookup'],
                                       coeffs)
    mesh = None
    if args.mesh:
        # SPMD export from the CLI: the batch dim shards over the FIRST
        # axis; extra axes replicate (e.g. '4x2').  Axis names follow the
        # library convention so `serve --mesh` round-trips.
        shape = _parse_mesh_spec(args.mesh)
        if len(shape) > 2:
            raise SystemExit(f'--mesh {args.mesh!r}: at most 2 axes '
                             '(batch x replication)')
        if args.polymorphic:
            raise SystemExit('--mesh and --polymorphic are mutually '
                             'exclusive (a symbolic batch cannot carry a '
                             'fixed sharding); export a fixed batch')
        if args.batch % shape[0]:
            raise SystemExit(
                f'--batch {args.batch} is not divisible by the '
                f'{shape[0]}-way batch axis of --mesh {args.mesh!r}')
        mesh = _build_cli_mesh(shape, ('data', 'model')[:len(shape)])
    dep = export_pipeline(
        args.pipeline,
        batch=None if args.polymorphic else args.batch,
        levels=args.levels, wind_levels=args.wind_levels,
        dtype=np.dtype(args.dtype), tables=tables, mesh=mesh,
        polymorphic=args.polymorphic,
        platforms=args.platforms.split(',') if args.platforms else None,
        slim=slim, path=args.output)
    print(f'wrote {args.output} ({os.path.getsize(args.output):,} bytes, '
          f"slim={dep.meta['slim']}, platforms={dep.meta['platforms']})")
    return 0


def _cli_serve(args):
    if args.cache is not None:
        enable_compilation_cache(args.cache or None)
    dep = load(args.artifact)
    if any(np.dtype(d).itemsize == 8 for d in
           [dep.meta.get('dtype', 'float32')]
           + list(dep.meta.get('table_dtypes', []))):
        # A float64 artifact cannot serve with x64 off: JAX would
        # canonicalize every input to f32 and fail the export-layer
        # dtype check.
        jax.config.update('jax_enable_x64', True)
    mesh = None
    if args.mesh:
        # SPMD serving on any matching topology: build the exported mesh
        # shape from the first prod(shape) local devices.  Without this
        # flag a mesh-exported artifact serves only when the process's
        # device count exactly equals the exported one (Deployed._mesh).
        want = dep.meta.get('mesh')
        if want is None:
            raise SystemExit('--mesh: this artifact was not exported with '
                             'mesh= (see `info`); it serves unsharded')
        shape = _parse_mesh_spec(args.mesh)
        names = tuple(want['axis_names'])
        # The exported HloShardings are positional: the serving mesh must
        # reproduce the exported axis SHAPE exactly — say so here rather
        # than letting Deployed._mesh raise mid-serve.
        if shape != tuple(want['shape']):
            raise SystemExit(
                f'--mesh {args.mesh!r}: the artifact was exported on a '
                f'mesh of shape {"x".join(str(s) for s in want["shape"])} '
                f'(axes {names}); the serving mesh must match it')
        mesh = _build_cli_mesh(shape, names)
    tables = None
    if args.tables:
        tables = adiabat.AdiabatTables.load(args.tables)
    elif not dep.meta.get('slim'):
        tables = _tables_or_load(None, dtype=dep.meta.get('table_dtype'))
    with np.load(args.input) as f:
        dat = {k: f[k] for k in f.files}
    dat, missing, extra = dep.check_inputs(dat)
    if missing:
        raise SystemExit(f'input {args.input} is missing required '
                         f'variables: {missing}')
    if extra:
        print(f'ignoring {len(extra)} unrecognized variables: {extra}')
    want = np.dtype(dep.meta.get('dtype', 'float32'))
    dat = {k: v.astype(want, copy=False) if v.dtype.kind == 'f' else v
           for k, v in dat.items()}
    out = dep(dat, tables=tables, mesh=mesh)
    out = dep._host(out)
    # Write through a file handle: np.savez on a PATH silently appends
    # '.npz' when the extension is missing, making the printed name lie.
    with open(args.output, 'wb') as f:
        np.savez(f, **{k: np.asarray(v) for k, v in out.items()})
    b = next(iter(out.values())).shape[0]
    print(f'wrote {args.output}: {len(out)} variables x {b:,} columns')
    return 0


def _cli_info(args):
    # meta.json only — info must work even when this process's jax
    # cannot deserialize the blob (the metadata's jax_version field is
    # exactly what explains such an incompatibility).
    print(json.dumps(_read_meta(args.artifact), indent=1))
    return 0


def main(argv=None):
    """``python -m xarray_parcel_tpu.deploy`` — export/serve from the
    command line.  With slim artifacts (the default) the serving side
    needs only the artifact zip and an ``.npz`` of input columns."""
    import argparse
    p = argparse.ArgumentParser(
        prog='python -m xarray_parcel_tpu.deploy',
        description='AOT export and file-to-file serving of the '
                    'convection pipelines.')
    sub = p.add_subparsers(dest='cmd', required=True)

    pe = sub.add_parser('export', help='export a pipeline artifact')
    pe.add_argument('--pipeline', default='conv_properties',
                    choices=sorted(PIPELINES))
    pe.add_argument('--batch', type=int, default=1 << 16)
    pe.add_argument('--levels', type=int, default=90)
    pe.add_argument('--wind-levels', type=int, default=None)
    pe.add_argument('--dtype', default='float32')
    pe.add_argument('--polymorphic', action='store_true')
    pe.add_argument('--platforms', default=None,
                    help="comma-separated, e.g. 'cpu,cuda'")
    pe.add_argument('--slim', default='auto',
                    choices=('auto', 'true', 'false'))
    pe.add_argument('--tables', default=None,
                    help='table .npz (default: the cached build)')
    pe.add_argument('--mesh', default=None,
                    help="export the SPMD program over a device mesh of "
                         "this shape, e.g. '8' or '4x2' (batch shards "
                         "over the first axis; uses the first N local "
                         "devices)")
    pe.add_argument('-o', '--output', required=True)
    pe.set_defaults(run=_cli_export)

    ps = sub.add_parser('serve', help='run an .npz of columns through an '
                                      'artifact')
    ps.add_argument('artifact')
    ps.add_argument('--input', required=True, help='.npz of input columns')
    ps.add_argument('-o', '--output', required=True, help='.npz to write')
    ps.add_argument('--tables', default=None,
                    help='table .npz (full-table artifacts only)')
    ps.add_argument('--cache', nargs='?', const='', default=None,
                    metavar='DIR',
                    help='turn on the persistent compile cache: '
                         '$JAX_COMPILATION_CACHE_DIR when set, else DIR, '
                         'else .xla_cache/ in the checkout')
    ps.add_argument('--mesh', default=None,
                    help="serving mesh shape for a mesh-exported artifact, "
                         "e.g. '8' or '4x2' (matches the exported axis "
                         "shape; uses the first N local devices)")
    ps.set_defaults(run=_cli_serve)

    pi = sub.add_parser('info', help='print artifact metadata')
    pi.add_argument('artifact')
    pi.set_defaults(run=_cli_info)

    args = p.parse_args(argv)
    return args.run(args)


#: The cache directory used when neither ``JAX_COMPILATION_CACHE_DIR`` nor
#: an explicit directory names one: fixed (the path is part of what makes
#: a cache hit), inside the checkout, and gitignored.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    '.xla_cache')


def enable_compilation_cache(directory=None, min_compile_time_secs=0.0):
    """Turn on JAX's persistent compilation cache; returns its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, always wins and no other
    directory is set.  Otherwise the cache goes to ``directory``, or to
    :data:`DEFAULT_CACHE_DIR` when that is None.  Compiled executables
    for identical programs are reused across processes — a serving fleet
    pays each pipeline's backend compile once per cache, not once per
    process.  Call before the first jit execution.
    """
    directory = (os.environ.get('JAX_COMPILATION_CACHE_DIR') or directory
                 or DEFAULT_CACHE_DIR)
    jax.config.update('jax_compilation_cache_dir', str(directory))
    jax.config.update('jax_persistent_cache_min_compile_time_secs',
                      float(min_compile_time_secs))
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    # The cache backend is a lazily-created singleton bound to the dir it
    # first saw — drop it so re-pointing mid-process actually re-points.
    from jax.experimental.compilation_cache import compilation_cache as _cc
    _cc.reset_cache()
    return str(directory)


if __name__ == '__main__':
    raise SystemExit(main())
