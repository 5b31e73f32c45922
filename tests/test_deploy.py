"""AOT export/serving artifacts (deploy.py): roundtrip, padding, cache.

The reference has no serving analogue (each dask session re-builds its
graph); these pin the beyond-reference deployment path: serialized
pipelines reload and reproduce the direct call exactly, fixed-batch
artifacts serve arbitrary grids, and the persistent compile cache fills.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xarray_parcel_tpu import adiabat, deploy, pipeline


@pytest.fixture(scope='module')
def tables():
    return adiabat.load_moist_adiabat_lookups()


def make_dat(B, L=24, seed=3):
    rng = np.random.default_rng(seed)
    p = np.linspace(1003.0, 180.0, L)
    p = np.broadcast_to(p, (B, L)) + rng.normal(0, 0.3, (B, L))
    p = -np.sort(-p, axis=-1)
    t = 300.0 - 70.0 * (1.0 - (p / 1003.0) ** 0.3) + rng.normal(0, 2, (B, L))
    td = t - (np.abs(rng.normal(2, 2, (B, L))) + 0.3 +
              12.0 * (1.0 - p / 1003.0) ** 2)
    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = 0.6219569100577033 * e / (p - e)
    q = w / (1.0 + w)
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    return {k: jnp.asarray(v) for k, v in {
        'pressure': p, 'temperature': t, 'specific_humidity': q,
        'height_asl': h,
        'surface_wind_u': rng.normal(3, 2, (B,)),
        'surface_wind_v': rng.normal(0, 2, (B,)),
        'wind_u': rng.normal(8, 5, (B, L)),
        'wind_v': rng.normal(2, 5, (B, L)),
        'wind_height_above_surface': h - h[..., :1],
    }.items()}


def assert_tree_equal(got, ref):
    assert set(got) == set(ref)
    for k in sorted(ref):
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                          err_msg=k)
            # The exported artifact runs as ONE compiled program; the
            # direct reference call executes eagerly — fp64 schedules
            # differ at the last-ulp scale (observed ~7e-12 rel).
            np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                       rtol=1e-9, atol=1e-12, err_msg=k)


DTYPE = jnp.float64  # the test suite pins x64; match the fixture arrays


@pytest.fixture(scope='module')
def artifact16(tables, tmp_path_factory):
    """One batch-16 min_conv_properties export shared by several tests
    (exports cost a whole-pipeline trace+compile each)."""
    path = tmp_path_factory.mktemp('deploy') / 'min_pipe.xpz'
    deployed = deploy.export_pipeline('min_conv_properties', batch=16,
                                      levels=24, dtype=DTYPE, tables=tables,
                                      path=path)
    return path, deployed


def test_export_save_load_roundtrip(tables, artifact16):
    path, deployed = artifact16
    dat = make_dat(16)
    assert path.exists()
    loaded = deploy.load(path)
    assert loaded.meta['pipeline'] == 'min_conv_properties'
    assert loaded.meta['batch'] == 16
    assert loaded.meta['levels'] == 24
    ref = pipeline.min_conv_properties(dat, tables=tables)
    assert_tree_equal(deployed(dat, tables=tables), ref)
    assert_tree_equal(loaded(dat, tables=tables), ref)


def test_fixed_batch_serves_any_grid(tables, artifact16):
    # 21 columns (pad within one chunk) and 37 (two chunks + pad) through
    # a batch-16 artifact must equal the direct whole-batch call.
    loaded = deploy.load(artifact16[0])
    for B in (21, 37):
        dat = make_dat(B, seed=B)
        ref = pipeline.min_conv_properties(dat, tables=tables)
        got = loaded(dat, tables=tables)
        assert all(np.asarray(v).shape[0] == B for v in got.values())
        assert_tree_equal(got, ref)


def test_fixed_batch_edge_errors(tables, artifact16):
    _, deployed = artifact16
    empty = {k: np.asarray(v)[:0] for k, v in make_dat(4).items()}
    with pytest.raises(ValueError, match='empty batch'):
        deployed(empty, tables=tables)
    mixed = make_dat(8)
    mixed['surface_wind_u'] = mixed['surface_wind_u'][:4]
    with pytest.raises(ValueError, match='mixed leading batch'):
        deployed(mixed, tables=tables)
    with pytest.raises(ValueError, match='polymorphic=True'):
        deploy.export_pipeline('min_conv_properties', batch=None,
                               tables=tables)
    # A mesh passed to an UNSHARDED artifact must raise, not be ignored.
    from xarray_parcel_tpu import parallel
    with pytest.raises(ValueError, match='not exported with mesh'):
        deployed(make_dat(16), tables=tables, mesh=parallel.make_mesh())


def test_polymorphic_batch(tables):
    deployed = deploy.export_pipeline('min_conv_properties', batch=None,
                                      levels=24, dtype=DTYPE, tables=tables,
                                      polymorphic=True)
    assert deployed.meta['batch'] is None
    for B in (8, 13):
        dat = make_dat(B, seed=B)
        assert_tree_equal(deployed(dat, tables=tables),
                          pipeline.min_conv_properties(dat, tables=tables))
    # The polymorphic path validates inputs like the fixed-batch path —
    # a mixed/0-d batch must raise this module's ValueError, not a
    # symbolic-shape constraint error from deep inside exported.call.
    mixed = make_dat(8)
    mixed['surface_wind_u'] = mixed['surface_wind_u'][:4]
    with pytest.raises(ValueError, match='mixed leading batch'):
        deployed(mixed, tables=tables)
    scalar = make_dat(8)
    scalar['surface_wind_u'] = np.float64(3.0)
    with pytest.raises(ValueError, match='0-d'):
        deployed(scalar, tables=tables)
    with pytest.raises(ValueError, match='empty input'):
        deployed({}, tables=tables)


def test_table_placement_memoized(tables, artifact16):
    # Serving loops must not re-transfer the tables per call: same
    # (tables, mesh) pair -> one placement entry, identical arrays.
    _, deployed = artifact16
    deployed._placed.clear()
    dat = make_dat(16, seed=40)
    deployed(dat, tables=tables)
    first = dict(deployed._placed)
    deployed(dat, tables=tables)
    assert len(deployed._placed) == 1
    (key, val), = deployed._placed.items()
    assert val[2] is first[key][2]
    # A second tables object is a second entry, not an eviction.
    tables2 = adiabat.AdiabatTables(tables.curves, tables.lookup,
                                    tables.coeffs)
    deployed(dat, tables=tables2)
    assert len(deployed._placed) == 2


def test_table_dtype_follows_artifact(tables, tmp_path):
    # A FULL-TABLE artifact exported with f32 tables must serve from a
    # process whose own config (x64 here) would pick the f64 cache: the
    # exported table signature, not the serving config, chooses the table
    # build.  (slim=False: slim artifacts never auto-load anything.)
    import jax.numpy as jnp
    tab32 = adiabat.AdiabatTables(
        np.asarray(tables.curves, np.float32), np.asarray(tables.lookup),
        np.asarray(tables.coeffs, np.float32))
    deployed = deploy.export_pipeline('min_conv_properties', batch=8,
                                      levels=24, dtype=jnp.float32,
                                      tables=tab32, slim=False)
    assert deployed.meta['table_dtype'] == 'float32'
    dat = {k: np.asarray(v, np.float32) if np.asarray(v).dtype.kind == 'f'
           else np.asarray(v) for k, v in make_dat(8, seed=41).items()}
    ref = deployed(dat, tables=tab32)
    # Auto-load (tables=None) must pick the f32 flavour; restore the
    # module's resident-table state afterwards (the suite runs fp64).
    prev = (adiabat._DEFAULT_TABLES, adiabat._DEFAULT_SOURCE)
    try:
        got = deployed(dat)
        auto = adiabat.default_tables()
        assert np.dtype(auto.curves.dtype) == np.float32
    finally:
        adiabat._DEFAULT_TABLES, adiabat._DEFAULT_SOURCE = prev
    assert_tree_equal({k: np.asarray(v) for k, v in got.items()},
                      {k: np.asarray(v) for k, v in ref.items()})


def test_fused_pipeline_exports(tables, tmp_path):
    # The fused pipelines are plain XLA: the artifact must reproduce the
    # direct call.
    path = tmp_path / 'fused.xpz'
    deploy.export_pipeline('min_conv_properties_fused', batch=8, levels=24,
                           dtype=DTYPE, tables=tables, path=path)
    loaded = deploy.load(path)
    dat = make_dat(8, seed=5)
    assert_tree_equal(loaded(dat, tables=tables),
                      pipeline.min_conv_properties_fused(dat, tables=tables))


def test_sharded_export(tables, tmp_path):
    # SPMD artifact: batch sharded over the suite's 8 virtual devices,
    # tables replicated.  Must reload and serve both an exact-fit batch
    # (stays sharded end to end) and a non-divisible grid (pad + chunk,
    # each chunk sharded) with results equal to the unsharded direct call.
    from xarray_parcel_tpu import parallel
    mesh = parallel.make_mesh()
    path = tmp_path / 'sharded.xpz'
    deploy.export_pipeline('min_conv_properties', batch=16, levels=24,
                           dtype=DTYPE, tables=tables, mesh=mesh, path=path)
    loaded = deploy.load(path)
    assert loaded.meta['mesh'] == {'axis_names': ['data'], 'shape': [8]}

    dat = make_dat(16, seed=21)
    ref = pipeline.min_conv_properties(dat, tables=tables)
    got = loaded(dat, tables=tables, mesh=mesh)
    assert len(got['mixed_100_cape'].sharding.device_set) == 8
    assert_tree_equal(got, ref)
    # Default mesh resolution (mesh=None) and the pad/chunk path.
    dat23 = make_dat(23, seed=22)
    assert_tree_equal(loaded(dat23, tables=tables),
                      pipeline.min_conv_properties(dat23, tables=tables))

    with pytest.raises(ValueError, match='divide evenly'):
        deploy.export_pipeline('min_conv_properties', batch=15, levels=24,
                               dtype=DTYPE, tables=tables, mesh=mesh)
    with pytest.raises(ValueError, match='do not compose'):
        deploy.export_pipeline('min_conv_properties', batch=None,
                               polymorphic=True, tables=tables, mesh=mesh)
    # Same device count but a different axis layout must be rejected —
    # the exported shardings are positional over the first axis.
    mesh42 = parallel.make_mesh(axis_names=('data', 'model'), shape=(4, 2))
    with pytest.raises(ValueError, match='mesh of shape'):
        loaded(dat, tables=tables, mesh=mesh42)
    # A 2-axis mesh shards the batch over axis 0 only: batch 12 is legal
    # on a (4, 2) mesh (12 % 4 == 0) even though 12 % 8 != 0.
    deploy.export_pipeline('min_conv_properties', batch=12, levels=24,
                           dtype=DTYPE, tables=tables, mesh=mesh42)


def test_polymorphic_fused_raises(tables):
    # A symbolic batch cannot carry a fixed sharding, fused or not.
    from xarray_parcel_tpu import parallel
    with pytest.raises(ValueError, match='do not compose'):
        deploy.export_pipeline('conv_properties_fused', batch=None,
                               polymorphic=True, tables=tables,
                               mesh=parallel.make_mesh())


def test_polymorphic_fused_roundtrip(tables, tmp_path):
    # The fused pipelines have no fixed grid any more: a symbolic-batch
    # export saves, reloads and serves any batch like the XLA pipelines.
    path = tmp_path / 'fused_poly.xpz'
    deploy.export_pipeline('min_conv_properties_fused', batch=None,
                           levels=24, dtype=DTYPE, tables=tables,
                           polymorphic=True, path=path)
    loaded = deploy.load(path)
    assert loaded.meta['polymorphic'] is True
    assert loaded.meta['batch'] is None
    for B in (5, 13):
        dat = make_dat(B, seed=B + 50)
        got = loaded(dat, tables=tables)
        assert all(np.asarray(v).shape[0] == B for v in got.values())
        assert_tree_equal(got, pipeline.min_conv_properties_fused(
            dat, tables=tables))


def test_load_rejects_foreign_zip(tmp_path):
    import zipfile
    path = tmp_path / 'other.zip'
    with zipfile.ZipFile(path, 'w') as z:
        z.writestr('meta.json', '{"format": "something-else"}')
        z.writestr('exported.stablehlo', b'')
    with pytest.raises(ValueError, match='not a'):
        deploy.load(path)


def test_exported_kwargs_are_closed_over(tables):
    dat = make_dat(8, seed=7)
    dat['temperature'] = dat['temperature'].at[0, 3].set(jnp.nan)
    deployed = deploy.export_pipeline('conv_properties', batch=8, levels=24,
                                      dtype=DTYPE, tables=tables,
                                      ignore_nans=True)
    ref = pipeline.conv_properties(dat, tables=tables, ignore_nans=True)
    assert_tree_equal(deployed(dat, tables=tables), ref)


def test_with_proxies_pipeline_exports(tables):
    dat = make_dat(8, seed=9)
    deployed = deploy.export_pipeline('conv_properties_with_proxies',
                                      batch=8, levels=24, dtype=DTYPE,
                                      tables=tables)
    ref = dict(pipeline.conv_properties(dat, tables=tables))
    ref.update(pipeline.storm_proxies(ref))
    got = deployed(dat, tables=tables)
    assert 'ship' in got and 'proxy_Craven2004' in got
    assert_tree_equal(got, ref)


def test_artifact_serves_in_a_fresh_process(tables, artifact16, tmp_path):
    # The serving claim proper: a process that never traced the pipeline
    # loads the artifact and reproduces this process's results.
    import subprocess, sys
    path, deployed = artifact16
    dat = make_dat(16, seed=33)
    ref = deployed(dat, tables=tables)
    datfile = tmp_path / 'dat.npz'
    outfile = tmp_path / 'out.npz'
    np.savez(datfile, **{k: np.asarray(v) for k, v in dat.items()})
    child = (
        "import numpy as np\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "from xarray_parcel_tpu import deploy, adiabat\n"
        # The artifact is slim: serving must never touch the table
        # cache/build path.  Make any attempt fail loudly.
        "def _no(*a, **k): raise RuntimeError('tables must not load')\n"
        "adiabat.load_moist_adiabat_lookups = _no\n"
        f"dat = dict(np.load({str(datfile)!r}))\n"
        f"dep = deploy.load({str(path)!r})\n"
        "assert dep.meta['slim'] is True\n"
        "out = dep(dat)\n"                       # embedded coefficients
        f"np.savez({str(outfile)!r}, "
        "**{k: np.asarray(v) for k, v in out.items()})\n")
    proc = subprocess.run([sys.executable, '-c', child], timeout=540,
                          capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = dict(np.load(outfile))
    assert_tree_equal(got, {k: np.asarray(v) for k, v in ref.items()})


def test_slim_artifact_is_standalone(tables, artifact16, tmp_path):
    """Auto-slim: registry pipelines read only tables.coeffs, so the
    artifact embeds them (~2-5 MB) and serves with NO tables argument and
    NO module table state — the zip is the whole deployment."""
    import zipfile
    path, deployed = artifact16
    assert deployed.meta['slim'] is True
    assert deployed.meta['table_dtypes'] == [
        np.dtype(np.asarray(tables.coeffs).dtype).name]
    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
    assert 'tables.npz' in names
    # Serve with tables=None, embedded coefficients only; equality with
    # both the explicit-tables serve and the direct pipeline call.
    dat = make_dat(16, seed=50)
    ref = pipeline.min_conv_properties(dat, tables=tables)
    assert_tree_equal(deployed(dat), ref)
    loaded = deploy.load(path)
    assert loaded._embedded is not None
    np.testing.assert_array_equal(loaded._embedded[0],
                                  np.asarray(tables.coeffs))
    assert_tree_equal(loaded(dat), ref)
    # Embedded placement is memoized under a stable key.
    loaded._placed.clear()
    loaded(dat)
    first = dict(loaded._placed)
    loaded(dat)
    assert len(loaded._placed) == 1
    (key, val), = loaded._placed.items()
    assert val[2] is first[key][2]


def test_slim_false_forces_full_tables(tables, tmp_path):
    import zipfile
    path = tmp_path / 'full.xpz'
    deploy.export_pipeline('min_conv_properties', batch=8, levels=24,
                           dtype=DTYPE, tables=tables, slim=False, path=path)
    loaded = deploy.load(path)
    assert loaded.meta['slim'] is False
    assert len(loaded.meta['table_dtypes']) == 3
    with zipfile.ZipFile(path) as z:
        assert 'tables.npz' not in set(z.namelist())
    dat = make_dat(8, seed=51)
    assert_tree_equal(loaded(dat, tables=tables),
                      pipeline.min_conv_properties(dat, tables=tables))


def test_slim_rejects_table_reading_pipeline(tables):
    """A pipeline that genuinely gathers from the full tables: slim=True
    raises naming the arrays; auto (None) falls back to full-table."""
    def lookup_pipeline(dat, tables=None):
        out = dict(pipeline.min_conv_properties(dat, tables=tables))
        # bilinear index mode reads tables.lookup (and the curve
        # evaluation reads tables.curves when coeffs are bypassed).
        out['ml_probe'] = adiabat.moist_lapse(
            dat['pressure'], dat['temperature'][..., 0],
            tables=tables, index_mode='bilinear', curve_blend=False)[..., 5]
        return out

    with pytest.raises(ValueError, match='curves.*lookup|lookup'):
        deploy.export_pipeline(lookup_pipeline, batch=8, levels=24,
                               dtype=DTYPE, tables=tables, slim=True)
    dep = deploy.export_pipeline(lookup_pipeline, batch=8, levels=24,
                                 dtype=DTYPE, tables=tables)
    assert dep.meta['slim'] is False
    dat = make_dat(8, seed=52)
    got = dep(dat, tables=tables)
    assert 'ml_probe' in got and np.isfinite(
        np.asarray(got['ml_probe'])).any()


def test_slim_sharded_export(tables):
    # slim + mesh: the embedded coefficients replicate over the mesh.
    from xarray_parcel_tpu import parallel
    mesh = parallel.make_mesh()
    dep = deploy.export_pipeline('min_conv_properties', batch=16,
                                 levels=24, dtype=DTYPE, tables=tables,
                                 mesh=mesh)
    assert dep.meta['slim'] is True
    dat = make_dat(16, seed=53)
    got = dep(dat, mesh=mesh)          # no tables at all
    assert len(got['mixed_100_cape'].sharding.device_set) == 8
    assert_tree_equal(got, pipeline.min_conv_properties(dat, tables=tables))


def test_cli_export_serve_info(tables, tmp_path, capsys):
    """python -m xarray_parcel_tpu.deploy: export -> serve file-to-file
    (slim artifact; no tables anywhere on the serving side)."""
    art = tmp_path / 'cli.xpz'
    assert deploy.main(['export', '--pipeline', 'min_conv_properties',
                        '--batch', '8', '--levels', '24',
                        '--dtype', 'float64', '-o', str(art)]) == 0
    dat = make_dat(12, seed=60)
    infile, outfile = tmp_path / 'in.npz', tmp_path / 'out.npz'
    np.savez(infile, **{k: np.asarray(v) for k, v in dat.items()},
             junk=np.arange(12.0))
    assert deploy.main(['serve', str(art), '--input', str(infile),
                        '-o', str(outfile)]) == 0
    ref = pipeline.min_conv_properties(dat, tables=tables)
    got = dict(np.load(outfile))
    assert_tree_equal(got, {k: np.asarray(v) for k, v in ref.items()})
    assert deploy.main(['info', str(art)]) == 0
    out = capsys.readouterr().out
    assert '"slim": true' in out
    assert 'ignoring 1 unrecognized' in out
    # Missing required variables fail with their names, not a tree error.
    np.savez(infile, pressure=np.asarray(dat['pressure']))
    with pytest.raises(SystemExit, match='missing required'):
        deploy.main(['serve', str(art), '--input', str(infile),
                     '-o', str(outfile)])


def test_cli_serve_mesh_exported_artifact(tables, tmp_path, capsys):
    """Full CLI SPMD round trip: `export --mesh 4` then `serve --mesh 4`
    on a topology whose local device count (8 here) differs from the
    exported one — previously mesh export was Python-API-only and the CLI
    could serve sharded artifacts only when the counts matched exactly.
    Output equals the direct single-device pipeline."""
    art = tmp_path / 'mesh4.xpz'
    assert deploy.main(['export', '--pipeline', 'min_conv_properties',
                        '--batch', '8', '--levels', '24',
                        '--dtype', 'float64', '--mesh', '4',
                        '-o', str(art)]) == 0
    assert deploy.load(art).meta['mesh'] == {'axis_names': ['data'],
                                             'shape': [4]}
    dat = make_dat(12, seed=61)
    infile, outfile = tmp_path / 'in.npz', tmp_path / 'out.npz'
    np.savez(infile, **{k: np.asarray(v) for k, v in dat.items()})
    assert deploy.main(['serve', str(art), '--input', str(infile),
                        '--mesh', '4', '-o', str(outfile)]) == 0
    ref = pipeline.min_conv_properties(dat, tables=tables)
    assert_tree_equal(dict(np.load(outfile)),
                      {k: np.asarray(v) for k, v in ref.items()})
    # Mismatched mesh shape and an unsharded artifact both fail clearly.
    with pytest.raises(SystemExit, match='must match it'):
        deploy.main(['serve', str(art), '--input', str(infile),
                     '--mesh', '2x2', '-o', str(outfile)])
    flat = tmp_path / 'flat.xpz'
    deploy.export_pipeline('min_conv_properties', batch=8, levels=24,
                           dtype=DTYPE, tables=tables, path=flat)
    with pytest.raises(SystemExit, match='not exported with mesh'):
        deploy.main(['serve', str(flat), '--input', str(infile),
                     '--mesh', '8', '-o', str(outfile)])


def test_slim_placeholders_keep_table_shapes(tables):
    """A custom pipeline that consults tables.lookup/curves SHAPES (but
    never their data) still auto-slims — and the trace-time placeholders
    carry the ORIGINAL shapes, so shape-derived outputs are correct
    rather than silently computed from (0, 0)."""
    nrows = int(np.shape(tables.lookup)[0])

    def shape_reader(dat, tables=None):
        out = dict(pipeline.min_conv_properties(dat, tables=tables))
        out['lookup_rows'] = jnp.full(
            dat['pressure'].shape[:1], float(tables.lookup.shape[0]),
            dat['pressure'].dtype)
        return out

    dep = deploy.export_pipeline(shape_reader, batch=8, levels=24,
                                 dtype=DTYPE, tables=tables)
    assert dep.meta['slim'] is True
    got = dep(make_dat(8, seed=54))
    np.testing.assert_array_equal(np.asarray(got['lookup_rows']),
                                  np.full(8, float(nrows)))


def test_slim_format_is_v2_full_is_v1(tables, artifact16, tmp_path):
    """Slim artifacts are written as format v2 so a pre-slim loader
    fails fast on the format check; full-table artifacts stay v1 (an old
    loader can still read them)."""
    _, deployed = artifact16
    assert deployed.meta['format'] == 'xarray-parcel-tpu-exported-v2'
    full = deploy.export_pipeline('min_conv_properties', batch=8,
                                  levels=24, dtype=DTYPE, tables=tables,
                                  slim=False)
    assert full.meta['format'] == 'xarray-parcel-tpu-exported-v1'


def test_spectral_less_tables_export_full_table(tables, tmp_path):
    """coeffs=None is a legal AdiabatTables state: auto-slim falls back
    to a 2-leaf full-table artifact (no AttributeError), slim=True raises
    the documented message, and the 2-leaf artifact serves."""
    bare = adiabat.AdiabatTables(tables.curves, tables.lookup, None)

    def lookup_only(dat, tables=None):
        # bilinear indexing reads curves+lookup, never coeffs — the one
        # pipeline shape that is meaningful on spectral-less tables.
        return {'ml': adiabat.moist_lapse(
            dat['pressure'], dat['temperature'][..., 0], tables=tables,
            index_mode='bilinear', curve_blend=False)}

    with pytest.raises(ValueError, match='coeffs is None'):
        deploy.export_pipeline(lookup_only, batch=8, levels=24,
                               dtype=DTYPE, tables=bare, slim=True)
    dep = deploy.export_pipeline(lookup_only, batch=8, levels=24,
                                 dtype=DTYPE, tables=bare,
                                 path=tmp_path / 'bare.xpz')
    assert dep.meta['slim'] is False
    assert len(dep.meta['table_dtypes']) == 2
    # 2 leaves is NOT the classic 3-leaf table tuple: a pre-slim loader
    # would feed it 3 leaves, so it must fail that loader's format check.
    assert dep.meta['format'] == 'xarray-parcel-tpu-exported-v2'
    dat = make_dat(8, seed=55)
    ref = lookup_only(dat, tables=bare)
    assert_tree_equal(deploy.load(tmp_path / 'bare.xpz')(dat, tables=bare),
                      ref)
    # Serving a 3-leaf artifact with coeffs-less tables names the problem.
    three = deploy.export_pipeline('min_conv_properties', batch=8,
                                   levels=24, dtype=DTYPE, tables=tables,
                                   slim=False)
    with pytest.raises(ValueError, match='coeffs=None'):
        three(dat, tables=bare)


def test_cli_serve_f64_artifact_without_x64(tables, artifact16, tmp_path):
    """The CLI must serve a float64 artifact from a DEFAULT process (x64
    off): it reads the artifact dtype and enables x64 itself."""
    import subprocess
    import sys
    path, _ = artifact16
    dat = make_dat(8, seed=56)
    infile = tmp_path / 'in.npz'
    outfile = tmp_path / 'out.results'   # no .npz: exact-name write
    np.savez(infile, **{k: np.asarray(v) for k, v in dat.items()})
    child = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"   # NOT x64
        "from xarray_parcel_tpu import deploy\n"
        f"raise SystemExit(deploy.main(['serve', {str(path)!r}, "
        f"'--input', {str(infile)!r}, '-o', {str(outfile)!r}]))\n")
    proc = subprocess.run([sys.executable, '-c', child], timeout=540,
                          capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert outfile.exists()              # savez did not append '.npz'
    got = dict(np.load(outfile))
    assert got['mixed_100_cape'].dtype == np.float64
    ref = pipeline.min_conv_properties(dat, tables=tables)
    assert_tree_equal(got, {k: np.asarray(v) for k, v in ref.items()})


def test_call_rejects_wrong_variable_names(artifact16):
    """Deployed.__call__ (the lowest serving surface) names missing and
    unrecognized variables instead of surfacing jax.export's treedef
    mismatch."""
    _, deployed = artifact16
    dat = make_dat(16, seed=57)
    dat['presure'] = dat.pop('pressure')        # typo: missing + extra
    with pytest.raises(ValueError, match=r"missing \['pressure'\].*"
                                         r"unrecognized \['presure'\]"):
        deployed(dat)


def test_cli_export_f64_tables_from_default_process(tables, tmp_path):
    """`export --dtype float32 --tables f64.npz` from a DEFAULT (x64-off)
    process must record/embed float64 tables: the raw npz dtypes are
    sniffed BEFORE AdiabatTables construction (construction with x64 off
    canonicalizes f64 arrays to f32, so a post-construction check can
    never fire)."""
    import subprocess
    import sys
    import zipfile
    import io
    tabfile = tmp_path / 'tabs_f64.npz'
    tables.save(tabfile)
    assert np.asarray(tables.coeffs).dtype == np.float64
    outfile = tmp_path / 'f64tab.xpz'
    child = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"   # NOT x64
        "from xarray_parcel_tpu import deploy\n"
        f"raise SystemExit(deploy.main(['export', '--pipeline', "
        f"'min_conv_properties', '--batch', '8', '--levels', '24', "
        f"'--dtype', 'float32', '--tables', {str(tabfile)!r}, "
        f"'-o', {str(outfile)!r}]))\n")
    proc = subprocess.run([sys.executable, '-c', child], timeout=540,
                          capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.dirname(
                              os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr[-2000:]
    with zipfile.ZipFile(outfile) as z:
        meta = __import__('json').loads(z.read('meta.json'))
        assert meta['table_dtypes'] == ['float64']      # slim: coeffs only
        with np.load(io.BytesIO(z.read('tables.npz'))) as d:
            assert d['coeffs'].dtype == np.float64


@pytest.fixture
def restore_cache(monkeypatch):
    """conftest.py enables the suite-wide cache — restore BOTH settings
    afterwards so the rest of the suite keeps its persistent cache."""
    prev_dir = jax.config.jax_compilation_cache_dir
    prev_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    if prev_dir is not None:
        deploy.enable_compilation_cache(prev_dir, prev_min)
    else:
        jax.config.update('jax_compilation_cache_dir', None)
        jax.config.update('jax_persistent_cache_min_compile_time_secs',
                          prev_min)


def test_compilation_cache_fills(tmp_path, monkeypatch, restore_cache):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    cache = tmp_path / 'xla_cache'
    deploy.enable_compilation_cache(cache)
    jax.jit(lambda x: x * 2.0 + 3.0)(jnp.arange(7.0)).block_until_ready()
    assert any(cache.iterdir()), 'persistent cache stayed empty'


@pytest.mark.parametrize('env_set', [True, False])
def test_compilation_cache_dir_choice(tmp_path, monkeypatch, restore_cache,
                                      env_set):
    # JAX_COMPILATION_CACHE_DIR, when set, wins over any directory the
    # caller names; unset, the default is the fixed .xla_cache/ in the
    # checkout — never a temporary or per-process path.
    env_dir = str(tmp_path / 'from_env')
    if env_set:
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', env_dir)
    else:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    got = deploy.enable_compilation_cache(
        tmp_path / 'explicit' if env_set else None)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = env_dir if env_set else os.path.join(checkout, '.xla_cache')
    assert got == want == deploy.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == want


def test_export_f64_requires_x64(tables):
    # In an x64-off process jax.export would silently canonicalize the
    # f64 specs to f32 while meta claims float64; export_pipeline must
    # refuse (the CLI flips x64 on before calling it).
    jax.config.update('jax_enable_x64', False)
    try:
        with pytest.raises(ValueError, match='float64 export requires'):
            deploy.export_pipeline('min_conv_properties', batch=4,
                                   levels=24, dtype=jnp.float64,
                                   tables=tables)
    finally:
        jax.config.update('jax_enable_x64', True)


def test_call_coerces_float_dtypes(tables, artifact16):
    # __call__ (the lowest serving surface) casts mismatched float inputs
    # to the exported dtype, like the CLI and xarray_api.serve do.
    _, deployed = artifact16
    dat64 = make_dat(16, seed=11)
    dat32 = {k: np.asarray(v, np.float32) for k, v in dat64.items()}
    ref = pipeline.min_conv_properties(
        {k: jnp.asarray(v, DTYPE) for k, v in dat32.items()},
        tables=tables)
    assert_tree_equal(deployed(dat32, tables=tables), ref)


def test_call_rejects_wrong_extents(tables, artifact16):
    # A 20-level grid through a 24-level artifact fails with the variable
    # named, not jax.export's internal aval mismatch.
    _, deployed = artifact16
    dat = {k: np.asarray(v)[:, :20] if np.asarray(v).ndim == 2 else v
           for k, v in make_dat(16).items()}
    with pytest.raises(ValueError, match='extents.*pressure'):
        deployed(dat, tables=tables)


def test_table_placement_is_bounded(tables, artifact16):
    # A serving loop constructing fresh table objects per call must not
    # pin every dead placement forever.
    _, deployed = artifact16
    dat = make_dat(16)
    for _ in range(6):
        fresh = adiabat.AdiabatTables(tables.curves, tables.lookup,
                                      tables.coeffs)
        deployed(dat, tables=fresh)
    assert len(deployed._placed) <= 4


def test_load_friendly_errors(tmp_path):
    # Non-zip file and zip-without-meta both get the artifact-format
    # ValueError, not KeyError/BadZipFile.
    not_zip = tmp_path / 'notes.txt'
    not_zip.write_text('hello')
    with pytest.raises(ValueError, match='not an xarray-parcel-tpu'):
        deploy.load(not_zip)
    import zipfile
    plain = tmp_path / 'plain.zip'
    with zipfile.ZipFile(plain, 'w') as z:
        z.writestr('readme.txt', 'x')
    with pytest.raises(ValueError, match='not an xarray-parcel-tpu'):
        deploy.load(plain)


def test_cli_info_skips_deserialize(tmp_path, capsys):
    # `info` must print meta.json even when the StableHLO blob cannot be
    # deserialized by this process's jax (meta carries the jax_version
    # that explains the incompatibility).
    import json
    import zipfile
    art = tmp_path / 'foreign.xpz'
    meta = {'format': 'xarray_parcel_tpu.deploy/1', 'pipeline': 'x',
            'jax_version': '99.0'}
    with zipfile.ZipFile(art, 'w') as z:
        z.writestr('meta.json', json.dumps(meta))
        z.writestr('exported.stablehlo', b'\x00garbage')
    assert deploy.main(['info', str(art)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out['jax_version'] == '99.0'
