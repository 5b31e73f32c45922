"""Generate the committed regression archive (tier-3 tests).

The reference archives full-pipeline outputs to NetCDF and diffs new runs
against them to catch cross-version drift
(reference: environment_changes_eval.ipynb, historic_results/*.nc).  Here the
archive is an .npz holding both the synthetic input grid and every
conv_properties + storm_proxies output, produced on the fp64 CPU backend.

Regenerate (only when output semantics intentionally change):
    python tests/make_regression_archive.py

Regeneration over an existing archive prints the reference's per-variable
drift table (max abs / max rel / NaN-pattern — reference:
environment_changes_eval.ipynb cells 9-14, via ``utils.compare_archives``)
and writes it to data/regression_drift.json, so every intentional semantic
change ships with a quantified, committed drift record.
"""

import json
import os

import numpy as np

ARCHIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                       'regression_conv_properties.npz')
DRIFT = os.path.join(os.path.dirname(ARCHIVE), 'regression_drift.json')


def make_inputs(ny=6, nx=6, L=40, seed=20260816):
    rng = np.random.default_rng(seed)
    p = np.linspace(1009.0, 140.0, L)
    p = np.broadcast_to(p, (ny, nx, L)) + rng.normal(0, 0.3, (ny, nx, L))
    p = -np.sort(-p, axis=-1)
    t = 302.0 - 77.0 * (1.0 - (p / 1009.0) ** 0.3) + rng.normal(
        0, 1.5, (ny, nx, L))
    td = t - (np.abs(rng.normal(1.5, 1.5, (ny, nx, L))) + 0.2 +
              16.0 * (1.0 - p / 1009.0) ** 2)

    # Row 1 is pinned inside SHIP's SPC validity windows (shear 7-27 m/s,
    # parcel mixing ratio 11-13.6 g/kg; diagnostics.py:135-137) so the
    # archive exercises SHIP *values*, not just its NaN pattern.  A steeper
    # (~6.5 K/km) temperature profile and fast-drying moisture keep the
    # surface the max-theta_e level (the base profile is so stable the
    # most-unstable parcel otherwise sits at the 250 hPa layer top, whose
    # mixing ratio falls outside the window).
    t = t.copy()
    td = td.copy()
    t[1] = 302.0 * (p[1] / 1009.0) ** 0.19 + rng.normal(0, 0.3, (nx, L))
    eps = 0.6219569100577033
    w_target = 0.0123
    e_target = w_target * p[1, :, 0] / (eps + w_target)
    log_e = np.log(e_target / 6.112)
    td[1, :, 0] = 243.5 * log_e / (17.67 - log_e) + 273.15
    # Moisture decreasing sharply aloft so level 0 stays most unstable.
    td[1, :, 1:] = np.minimum(td[1, :, 1:],
                              td[1, :, :1] - np.arange(1, L) * 2.0)
    td = np.minimum(td, t - 0.2)

    e = 6.112 * np.exp(17.67 * (td - 273.15) / (td - 29.65))
    w = eps * e / (p - e)
    q = w / (1.0 + w)
    h = 44330.0 * (1.0 - (p / 1013.25) ** 0.19)
    # One all-NaN-poisoned column to pin the masking semantics.
    t = t.copy()
    t[0, 0, 5] = np.nan

    su = rng.normal(3, 2, (ny, nx))
    sv = rng.normal(0, 2, (ny, nx))
    wu = rng.normal(8, 5, (ny, nx, L))
    wv = rng.normal(2, 5, (ny, nx, L))
    hw = h - h[..., :1]
    # Row 1: 15 m/s bulk shear at 6 km (inside the 7-27 m/s window).
    su[1, :] = 3.0
    sv[1, :] = 0.0
    wu[1] = 3.0 + 15.0 * np.clip(hw[1] / 6000.0, 0.0, 2.0)
    wv[1] = 0.0
    return {
        'pressure': p, 'temperature': t, 'specific_humidity': q,
        'height_asl': h,
        'surface_wind_u': su,
        'surface_wind_v': sv,
        'wind_u': wu,
        'wind_v': wv,
        'wind_height_above_surface': hw,
    }


def load_archive():
    """(inputs, expected outputs) of the committed archive."""
    with np.load(ARCHIVE) as f:
        return ({k[3:]: f[k] for k in f.files if k.startswith('in_')},
                {k[4:]: f[k] for k in f.files if k.startswith('out_')})


def assert_matches_archive(got, expect):
    """The regression tolerance: the same variable set, exact booleans
    and NaN patterns, values within ``atol=1e-4*scale, rtol=1e-6``."""
    assert set(got) == set(expect), (
        f'variable set changed: +{set(got) - set(expect)} '
        f'-{set(expect) - set(got)}')
    for k in sorted(expect):
        a, b = got[k], expect[k]
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f'drift in {k}')
            continue
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                      err_msg=f'NaN-pattern drift in {k}')
        scale = max(1.0, float(np.nanmax(np.abs(b))) * 1e-6)
        np.testing.assert_allclose(
            np.nan_to_num(a), np.nan_to_num(b), atol=1e-4 * scale, rtol=1e-6,
            err_msg=f'value drift in {k}')


def compute(inputs):
    """Every archived output for ``inputs``, in fp64 on JAX's default
    backend (the CPU when run as a script)."""
    import jax
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    from xarray_parcel_tpu import adiabat, pipeline

    tables = adiabat.load_moist_adiabat_lookups()
    dat = {k: jnp.asarray(v) for k, v in inputs.items()}

    @jax.jit
    def run(dat, tables):
        out = pipeline.conv_properties(dat, tables=tables)
        out.update(pipeline.storm_proxies(out))
        # The reduced pipeline is archived too (distinct code path; keys
        # get a 'min.' namespace so they never collide with conv_properties
        # keys).
        out.update({f'min.{k}': v
                    for k, v in pipeline.min_conv_properties(
                        dat, tables=tables).items()})
        return out

    return {k: np.asarray(v) for k, v in run(dat, tables).items()}


def main():
    inputs = make_inputs()
    out = compute(inputs)
    for k, v in out.items():
        if v.dtype != bool:
            assert not np.all(np.isnan(v)), \
                f'output {k!r} is unintentionally all-NaN'
    assert np.isfinite(out['ship']).any(), \
        'no archive column lands inside the SHIP validity windows'
    identical = False
    if os.path.exists(ARCHIVE):
        # Quantify the drift vs the archive being replaced (the reference's
        # current-vs-historic evaluation) and commit the record alongside.
        from xarray_parcel_tpu.utils import compare_archives
        print(f'drift vs existing {os.path.basename(ARCHIVE)}:')
        report = compare_archives(out, ARCHIVE)
        with open(DRIFT, 'w') as f:
            json.dump(report, f, indent=1, sort_keys=True)
        print(f'wrote {DRIFT}')
        # Bit-identical outputs leave the committed archive untouched, so a
        # pure drift run (committing a refreshed drift record) never churns
        # the .npz bytes in git.
        with np.load(ARCHIVE) as old:
            identical = (report['equal'] and
                         all(np.array_equal(old[f'out_{k}'], v,
                                            equal_nan=True)
                             for k, v in out.items()))
    if identical:
        print(f'{os.path.basename(ARCHIVE)} unchanged (bit-identical '
              'outputs); archive left as committed')
        return
    os.makedirs(os.path.dirname(ARCHIVE), exist_ok=True)
    np.savez_compressed(ARCHIVE,
                        **{f'in_{k}': v for k, v in inputs.items()},
                        **{f'out_{k}': v for k, v in out.items()})
    print(f'wrote {ARCHIVE}: {len(out)} output variables')


if __name__ == '__main__':
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    main()
