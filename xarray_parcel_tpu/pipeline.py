"""Batch diagnostic pipelines — the "run everything on a dataset" layer.

Vectorised equivalents of reference: modules/parcel_functions.py:1872-2100
(``conv_properties`` / ``min_conv_properties``) and :2323-2407
(``storm_proxies``).  One jittable pure function produces the full ~25
variable set for every column at once; under jit the whole pipeline is a
single fused XLA program (the reference builds a lazy dask graph instead and
pays per-chunk task overhead).

Inputs are a dict of (…, L) arrays with the reference's variable names:
``pressure``, ``temperature``, ``specific_humidity``, ``height_asl`` and the
wind set (``surface_wind_u``/``surface_wind_v`` (…), ``wind_u``/``wind_v``/
``wind_height_above_surface`` (…, Lw)).
"""

import jax.numpy as jnp

from . import diagnostics as diag
from . import thermo
from .parcels import mixed_layer_cape_cin, most_unstable_cape_cin
from .fieldset import annotate


def _prefix(d, prefix):
    return {f'{prefix}_{k}': v for k, v in d.items()}


def conv_properties(dat, ignore_nans=False, tables=None, moist_lapse=None,
                    with_attrs=False):
    """Full convection-diagnostics pipeline
    (reference: modules/parcel_functions.py:1951-2100).

    Returns a dict with: mu/mixed_100/mixed_50 cape+cin, three lifted
    indices, three DCIs, the most-unstable parcel mixing ratio, 700-500 hPa
    lapse rate, 500 hPa temperature, freezing/melting level heights and 0-6 km
    shear — NaN-masked wherever any input column is invalid (unless
    ``ignore_nans``).
    """
    kw = dict(tables=tables, moist_lapse=moist_lapse)
    p = jnp.asarray(dat['pressure'])
    t = jnp.asarray(dat['temperature'])
    q = jnp.asarray(dat['specific_humidity'])

    dew = thermo.dewpoint_from_specific_humidity(p, t, q)

    valid = ~(jnp.isnan(dew).any(-1) | jnp.isnan(p).any(-1) |
              jnp.isnan(t).any(-1) | jnp.isnan(q).any(-1))

    mu_cc, mu_prof, mu_parcel = most_unstable_cape_cin(
        p, t, dew, depth=250.0, **kw)
    # theta / saturation mixing ratio are shared by the two mixing depths.
    from .parcels import bridge_neighbors, conserved_fields
    cons = conserved_fields(p, t, dew)
    nbrs = bridge_neighbors(p, ~(jnp.isnan(p) | jnp.isnan(t) |
                                 jnp.isnan(dew)))
    m100_cc, m100_prof, _ = mixed_layer_cape_cin(p, t, dew, depth=100.0,
                                                 neighbors=nbrs,
                                                 conserved=cons, **kw)
    m50_cc, m50_prof, _ = mixed_layer_cape_cin(p, t, dew, depth=50.0,
                                               neighbors=nbrs,
                                               conserved=cons, **kw)

    mu_li = diag.lifted_index(mu_prof)['lifted_index']
    m100_li = diag.lifted_index(m100_prof)['lifted_index']
    m50_li = diag.lifted_index(m50_prof)['lifted_index']

    # The 850 hPa anchors depend only on the environment — computed once,
    # shared by all three DCIs (only the LI differs per parcel).
    from .ops import interp_many
    anchors_850 = interp_many((t, dew), p, 850.0, log=True)
    mu_dci = diag.deep_convective_index(p, t, dew, mu_li,
                                        anchors_850=anchors_850)['dci']
    m100_dci = diag.deep_convective_index(p, t, dew, m100_li,
                                          anchors_850=anchors_850)['dci']
    m50_dci = diag.deep_convective_index(p, t, dew, m50_li,
                                         anchors_850=anchors_850)['dci']

    mu_mixing_ratio = thermo.mixing_ratio_from_specific_humidity(
        thermo.specific_humidity_from_dewpoint(mu_parcel['pressure'],
                                               mu_parcel['dewpoint']))

    height = jnp.asarray(dat['height_asl'])
    # temp_500 IS the lapse computation's 500 hPa isobar temperature (same
    # interpolation semantics) — one anchor computation for both outputs.
    lapse, _, temp_500 = diag.lapse_rate(p, t, height, with_isobars=True)
    flh = diag.freezing_level_height(t, height)
    mlh, _ = diag.melting_level_height(p, t, dew, height, fast=True)

    shear = diag.wind_shear(dat['surface_wind_u'], dat['surface_wind_v'],
                            dat['wind_u'], dat['wind_v'],
                            dat['wind_height_above_surface'],
                            shear_height=6000.0)

    out = {}
    out.update(_prefix(mu_cc, 'mu'))
    out['mu_mixing_ratio'] = mu_mixing_ratio
    out.update(_prefix(m100_cc, 'mixed_100'))
    out.update(_prefix(m50_cc, 'mixed_50'))
    out['mu_lifted_index'] = mu_li
    out['mixed_100_lifted_index'] = m100_li
    out['mixed_50_lifted_index'] = m50_li
    out['mu_dci'] = mu_dci
    out['mixed_100_dci'] = m100_dci
    out['mixed_50_dci'] = m50_dci
    out['lapse_rate_700_500'] = lapse
    out['temp_500'] = temp_500
    out['freezing_level'] = flh
    out['melting_level'] = mlh
    out.update(shear)

    if not ignore_nans:
        for k, v in out.items():
            if v.dtype == bool:
                out[k] = jnp.where(valid, v, False)
            else:
                out[k] = jnp.where(valid, v, jnp.nan)
    return annotate(out) if with_attrs else out


def _fused_solve(fields, parcel, tables, in_kernel_li):
    """One fused CAPE/CIN solve + lifted index for an arbitrary parcel —
    LI inside the fused solve by default, else LI interpolated from the
    solve's profile tracks.  Shared by the fused pipelines."""
    from . import fused as _fused
    res, _ = _fused.fused_cape_cin(
        fields['pressure'], fields['temperature'], fields['dewpoint'],
        parcel_pressure=parcel['pressure'],
        parcel_temperature=parcel['temperature'],
        parcel_dewpoint=parcel['dewpoint'],
        tables=tables, with_lifted_index=in_kernel_li,
        with_profile=not in_kernel_li)
    if not in_kernel_li:
        res['lifted_index'] = diag.lifted_index(res.pop('profile'))[
            'lifted_index']
    return res


def conv_properties_fused(dat, ignore_nans=False, tables=None,
                          with_attrs=False, in_kernel_li=True,
                          mix_grow=False):
    """``conv_properties`` on the fused production path.

    Same variables, same semantics (the fused solve reuses the same column
    ops); the three CAPE/CIN solves and their lifted indices run as fused
    column programs instead of materialising profiles — the deployment
    path for dense grids.

    ``in_kernel_li``: compute the lifted index inside the fused solve
    (shared interpolation anchors, no profile materialisation); off,
    profile tracks come out of the solve and the LI interpolates them.
    ``mix_grow``: True re-enables the (L+1) insert_level splice for the
    mixed-layer environments (the slot-write default produces the same
    physical profile without the splice's shift network — an A/B knob).
    """
    from .parcels import (bridge_neighbors, from_most_unstable_parcel,
                          mix_layer)

    p = jnp.asarray(dat['pressure'])
    t = jnp.asarray(dat['temperature'])
    q = jnp.asarray(dat['specific_humidity'])

    dew = thermo.dewpoint_from_specific_humidity(p, t, q)
    valid = ~(jnp.isnan(dew).any(-1) | jnp.isnan(p).any(-1) |
              jnp.isnan(t).any(-1) | jnp.isnan(q).any(-1))

    def solve(fields, parcel):
        return _fused_solve(fields, parcel, tables, in_kernel_li)

    mu_fields, mu_parcel = from_most_unstable_parcel(p, t, dew, depth=250.0)
    mu = solve(mu_fields, mu_parcel)
    # theta / saturation mixing ratio are shared by the two mixing depths.
    from .parcels import conserved_fields
    cons = conserved_fields(p, t, dew)
    nbrs = bridge_neighbors(p, ~(jnp.isnan(p) | jnp.isnan(t) |
                                 jnp.isnan(dew)))
    m100_fields, m100_parcel = mix_layer(p, t, dew, depth=100.0,
                                         conserved=cons, neighbors=nbrs,
                                         grow=mix_grow)
    m100 = solve(m100_fields, m100_parcel)
    m50_fields, m50_parcel = mix_layer(p, t, dew, depth=50.0, conserved=cons,
                                       neighbors=nbrs, grow=mix_grow)
    m50 = solve(m50_fields, m50_parcel)

    mu_mixing_ratio = thermo.mixing_ratio_from_specific_humidity(
        thermo.specific_humidity_from_dewpoint(mu_parcel['pressure'],
                                               mu_parcel['dewpoint']))

    height = jnp.asarray(dat['height_asl'])
    # Shared diagnostic anchors: one 850 hPa interpolation for the three
    # DCIs; temp_500 reused from the lapse computation's 500 hPa isobar.
    from .ops import interp_many
    anchors_850 = interp_many((t, dew), p, 850.0, log=True)
    lapse, _, temp_500 = diag.lapse_rate(p, t, height, with_isobars=True)
    out = {
        'mu_cape': mu['cape'], 'mu_cin': mu['cin'],
        'mu_mixing_ratio': mu_mixing_ratio,
        'mixed_100_cape': m100['cape'], 'mixed_100_cin': m100['cin'],
        'mixed_50_cape': m50['cape'], 'mixed_50_cin': m50['cin'],
        'mu_lifted_index': mu['lifted_index'],
        'mixed_100_lifted_index': m100['lifted_index'],
        'mixed_50_lifted_index': m50['lifted_index'],
        'mu_dci': diag.deep_convective_index(
            p, t, dew, mu['lifted_index'], anchors_850=anchors_850)['dci'],
        'mixed_100_dci': diag.deep_convective_index(
            p, t, dew, m100['lifted_index'], anchors_850=anchors_850)['dci'],
        'mixed_50_dci': diag.deep_convective_index(
            p, t, dew, m50['lifted_index'], anchors_850=anchors_850)['dci'],
        'lapse_rate_700_500': lapse,
        'temp_500': temp_500,
        'freezing_level': diag.freezing_level_height(t, height),
        'melting_level': diag.melting_level_height(p, t, dew, height,
                                                   fast=True)[0],
    }
    out.update(diag.wind_shear(dat['surface_wind_u'], dat['surface_wind_v'],
                               dat['wind_u'], dat['wind_v'],
                               dat['wind_height_above_surface'],
                               shear_height=6000.0))

    if not ignore_nans:
        for k, v in out.items():
            if v.dtype == bool:
                out[k] = jnp.where(valid, v, False)
            else:
                out[k] = jnp.where(valid, v, jnp.nan)
    return annotate(out) if with_attrs else out


def min_conv_properties(dat, tables=None, moist_lapse=None,
                        with_attrs=False):
    """Reduced pipeline: mixed-100 CAPE/CIN + LI, lapse, T500, FLH, MLH,
    shear (reference: modules/parcel_functions.py:1872-1949)."""
    kw = dict(tables=tables, moist_lapse=moist_lapse)
    p = jnp.asarray(dat['pressure'])
    t = jnp.asarray(dat['temperature'])
    q = jnp.asarray(dat['specific_humidity'])
    dew = thermo.dewpoint_from_specific_humidity(p, t, q)

    m100_cc, m100_prof, _ = mixed_layer_cape_cin(p, t, dew, depth=100.0, **kw)
    m100_li = diag.lifted_index(m100_prof)['lifted_index']

    height = jnp.asarray(dat['height_asl'])
    out = dict(_prefix(m100_cc, 'mixed_100'))
    out['mixed_100_lifted_index'] = m100_li
    lapse, _, temp_500 = diag.lapse_rate(p, t, height, with_isobars=True)
    out['lapse_rate_700_500'] = lapse
    out['temp_500'] = temp_500
    out['freezing_level'] = diag.freezing_level_height(t, height)
    mlh, _ = diag.melting_level_height(p, t, dew, height, fast=True)
    out['melting_level'] = mlh
    out.update(diag.wind_shear(dat['surface_wind_u'], dat['surface_wind_v'],
                               dat['wind_u'], dat['wind_v'],
                               dat['wind_height_above_surface'],
                               shear_height=6000.0))
    return annotate(out) if with_attrs else out


def min_conv_properties_fused(dat, tables=None, with_attrs=False,
                              in_kernel_li=True):
    """``min_conv_properties`` on the fused production path
    (reference: modules/parcel_functions.py:1872-1949).

    Same variables, same semantics as the modular reduced pipeline
    (including its lack of a valid-column mask — NaN columns propagate
    through the solve's NaN contract); the mixed-100 CAPE/CIN solve and
    its lifted index run as one fused column program instead of
    materialising the parcel profile.
    """
    from .parcels import mix_layer

    p = jnp.asarray(dat['pressure'])
    t = jnp.asarray(dat['temperature'])
    q = jnp.asarray(dat['specific_humidity'])
    dew = thermo.dewpoint_from_specific_humidity(p, t, q)

    m100_fields, m100_parcel = mix_layer(p, t, dew, depth=100.0, grow=False)
    res = _fused_solve(m100_fields, m100_parcel, tables, in_kernel_li)

    height = jnp.asarray(dat['height_asl'])
    out = {'mixed_100_cape': res['cape'], 'mixed_100_cin': res['cin'],
           'mixed_100_lifted_index': res['lifted_index'],
           'lapse_rate_700_500': (_l := diag.lapse_rate(
               p, t, height, with_isobars=True))[0],
           'temp_500': _l[2],
           'freezing_level': diag.freezing_level_height(t, height),
           'melting_level': diag.melting_level_height(p, t, dew, height,
                                                      fast=True)[0]}
    out.update(diag.wind_shear(dat['surface_wind_u'], dat['surface_wind_v'],
                               dat['wind_u'], dat['wind_v'],
                               dat['wind_height_above_surface'],
                               shear_height=6000.0))
    return annotate(out) if with_attrs else out


#: Exactly the conv_properties output variables storm_proxies reads —
#: surfaces subset to this so a merged Dataset with extra (even
#: level-carrying) variables neither retraces nor transposes them.
STORM_PROXY_INPUTS = (
    'mu_cape', 'mu_mixing_ratio', 'mixed_100_cape', 'mixed_100_cin',
    'mixed_100_lifted_index', 'mixed_100_dci', 'mixed_50_cape',
    'mixed_50_cin', 'lapse_rate_700_500', 'temp_500', 'freezing_level',
    'shear_magnitude', 'positive_shear')


def storm_proxies(dat, with_attrs=False):
    """Literature storm-proxy booleans + SHIP
    (reference: modules/parcel_functions.py:2323-2407).

    ``dat`` is the output of ``conv_properties`` (the keys read are
    :data:`STORM_PROXY_INPUTS`).
    """
    s06 = dat['shear_magnitude']
    m100 = jnp.where(dat['mixed_100_cape'] >= 0, dat['mixed_100_cape'],
                     jnp.nan)
    m50 = jnp.where(dat['mixed_50_cape'] >= 0, dat['mixed_50_cape'], jnp.nan)
    mu = jnp.where(dat['mu_cape'] >= 0, dat['mu_cape'], jnp.nan)

    out = {}
    out['proxy_Craven2004'] = (m100 * s06) >= 20000.0
    out['proxy_Kunz2007'] = ((dat['mixed_100_lifted_index'] <= -2.07) |
                             (mu >= 1474.0) |
                             (dat['mixed_100_dci'] >= 25.7))
    trapp = ((m100 * s06 >= 10000.0) & (m100 >= 100.0) & (s06 >= 5.0) &
             dat['positive_shear'])
    out['proxy_Trapp2007'] = trapp
    out['proxy_Marsh2009'] = (m100 * s06) >= 10000.0
    out['proxy_Allen2011'] = m50 * s06 ** 1.67 >= 25000.0
    out['proxy_Allen2014'] = (out['proxy_Allen2011'] &
                              (dat['mixed_50_cin'] > -25.0) &
                              (s06 > 7.5) &
                              (dat['lapse_rate_700_500'] < -6.5))
    out['proxy_Eccel2012'] = ((m100 * s06 > 10000.0) &
                              (dat['mixed_100_cin'] > -50.0))
    out['proxy_Mohr2013'] = ((dat['mixed_100_lifted_index'] <= -1.6) |
                             (m100 >= 439.0) |
                             (dat['mixed_100_dci'] >= 26.4))
    ship = diag.significant_hail_parameter(
        mucape=mu, mixing_ratio=dat['mu_mixing_ratio'],
        lapse=dat['lapse_rate_700_500'], temp_500=dat['temp_500'],
        shear=s06, flh=dat['freezing_level'])
    out['ship'] = ship
    out['proxy_SHIP_0.1'] = ship > 0.1
    return annotate(out) if with_attrs else out
