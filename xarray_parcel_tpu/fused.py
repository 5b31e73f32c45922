"""Fused CAPE/CIN: the whole per-column solve as one compiled program.

The reference's one native kernel is a numba gufunc for curve interpolation
(reference: modules/parcel_functions.py:23-37).  Here one jitted column
program evaluates the ENTIRE per-column CAPE/CIN solve — parcel profile
(dry + spectral moist tracks), virtual-temperature tracks, LCL splice,
LFC/EL selection and the exact-area CAPE/CIN integration — from one read of
(pressure, temperature, dewpoint) to one scalar per output.  The modular
path (``cape.cape_cin``) materialises the parcel profile as a library
value; this path never returns it, so XLA is free to fuse the chain.

The program calls the SAME jnp column ops as the modular path (thermo /
ops / cape functions), so there is exactly one source of truth for the
physics and the reference semantics.

Stages that need gathers or per-column scalar iteration (the LCL fixed
point, the backward curve-index integration, the coefficient-row blend)
run first as a per-parcel pre-pass — O(batch) work, no (batch, levels)
traffic.
"""

import functools
import math

import jax
import jax.numpy as jnp

from . import adiabat, thermo
from . import constants as c
from .adiabat import P_BOT, P_TOP, _eval_spectral
from .cape import cape_cin_base, lfc_el
from .lcl import lcl
from .ops import (find_intersections, insert_level, interp_many, notnan,
                  safe_log)


def _column_program(p, t, td, row, lcl_p, lcl_t, lcl_vt, w0, t0, p0, k0,
                    virtual_temperature_correction=True, lcl_interp='log',
                    with_lifted_index=False, with_profile=False,
                    **cape_kwargs):
    """The per-column CAPE/CIN program on plain jnp values.

    ``p``/``t``/``td``: (B, L); ``row``: (B, K) blended Chebyshev
    coefficient rows (NaN row = invalid/out-of-envelope parcel);
    remaining args: (B,) per-column scalars — ``k0`` is the first-valid
    level index (leading-NaN prefix length of masked sub-parcel columns).
    Mirrors cape.cape_cin(...) for an arbitrary parcel
    (reference: modules/parcel_functions.py:712-780, 806-931, 1394-1475).
    With ``with_lifted_index`` also returns the Galway lifted index from the
    real-temperature tracks (reference: :1722-1756).
    """
    def ex(s):
        return s[..., None]

    lcl_pb = ex(lcl_p)

    # NaN levels (masked sub-parcel prefixes / poisoned data) must produce
    # NaN outputs but never ENTER the arithmetic: exp/log/power/multiply
    # leak NaN into reverse-mode cotangents even when masked downstream
    # (the where-NaN gradient trap), so every track is computed on safe
    # finite dummies with the NaN pattern applied after.
    validp = notnan(p)
    safe_p = jnp.where(validp, p, P_TOP)
    lp = safe_log(p)
    safe_lp = jnp.where(validp, lp, math.log(P_TOP))

    # Parcel temperature track: dry below the LCL, spectral moist above.
    # Poisson exponential reuses the block's safe ln(p) instead of
    # thermo.dry_lapse's (p/p0)**kappa: kills a vector divide and the
    # pow's internal log (log(p0) is a per-column scalar).  Same values
    # to ~1 ulp, same NaN/inf propagation.
    dry = ex(t0) * jnp.exp(c.kappa * (safe_lp - jnp.log(ex(p0))))
    moist = _eval_spectral(row, safe_p, log_pressure=safe_lp)
    moist = jnp.where((p >= P_BOT) & (p <= P_TOP), moist, jnp.nan)
    temp = jnp.where(p >= lcl_pb, dry, moist)
    temp = jnp.where(validp, temp, jnp.nan)

    # Mixing ratio: parcel's below the LCL, saturated above; virtual temps.
    validt = notnan(temp)
    safe_temp = jnp.where(validt, temp, 273.15)
    sat_w = thermo.saturation_mixing_ratio(safe_p, safe_temp)
    w = jnp.where(p <= lcl_pb, sat_w, ex(w0))
    vt = jnp.where(validt, thermo.virtual_temperature(safe_temp, w), jnp.nan)

    valid_env = validp & notnan(t) & notnan(td)
    safe_t = jnp.where(valid_env, t, 273.15)
    safe_td = jnp.where(valid_env, td, 263.15)
    env_vt = jnp.where(
        valid_env,
        thermo.virtual_temperature(safe_t,
                                   thermo.mixing_ratio(safe_t, safe_td,
                                                       safe_p)),
        jnp.nan)

    # ln(p) computed ONCE (above); the spliced column's log-pressure comes
    # from the same insert_level shifts (no second transcendental), and the
    # crossing set stays in log space end to end.
    llcl = safe_log(lcl_p)

    # Environment interpolated at the LCL; env virtual T recomputed there
    # (one shared anchor computation for both variables).
    t_at, td_at = interp_many((t, td), p, lcl_p, log=lcl_interp == 'log',
                              log_coords=lp)
    envvt_at = thermo.virtual_temperature(
        t_at, thermo.mixing_ratio(t_at, td_at, lcl_p))
    envt_at = t_at

    if virtual_temperature_correction:
        parcel_track, env_track, lcl_track = vt, env_vt, lcl_vt
        env_at = envvt_at
    else:
        parcel_track, env_track, lcl_track = temp, t, lcl_t
        env_at = envt_at

    fields = {'pressure': p, 'log_pressure': lp, 'parcel': parcel_track,
              'env': env_track}
    level = {'pressure': lcl_p, 'log_pressure': llcl, 'parcel': lcl_track,
             'env': env_at}
    if with_lifted_index or with_profile:
        fields.update(ptemp=temp, etemp=t)
        level.update(ptemp=lcl_t, etemp=envt_at)
    # The LCL splices at/above the first valid level, so the leading-NaN
    # prefix (and with it the first-valid index) is unchanged by the splice.
    ins = insert_level(fields, level, lead=k0)
    ins_lp = ins['log_pressure']

    ints = find_intersections(ins['pressure'], ins['parcel'], ins['env'],
                              log_x=True, log_x_values=ins_lp,
                              log_outputs=True)
    sol = lfc_el(ins['pressure'], ins['parcel'], ins['env'], lcl_p,
                 lcl_track, intersections=ints, log_pressure=ins_lp,
                 log_lcl_pressure=llcl, intersections_in_log=True,
                 first_valid=k0)
    res = cape_cin_base(ins['pressure'], ins['env'], sol['lfc_pressure'],
                        sol['el_pressure'], ins['parcel'],
                        intersections=ints, log_pressure=ins_lp,
                        log_lfc_pressure=sol.pop('_lfc_log_pressure'),
                        log_el_pressure=sol.pop('_el_log_pressure'),
                        **cape_kwargs)
    if with_lifted_index:
        env500, par500 = interp_many(
            (ins['etemp'], ins['ptemp']), ins['pressure'], 500.0,
            log=True, log_coords=ins_lp)
        res['lifted_index'] = env500 - par500
    if with_profile:
        res['profile'] = {'pressure': ins['pressure'],
                          'temperature': ins['ptemp'],
                          'environment_temperature': ins['etemp']}
    return res, sol


@functools.partial(jax.jit, static_argnames=('with_lifted_index',
                                             'with_profile', 'options'))
def _solve(p, t, td, p0, t0, td0, tables, with_lifted_index, with_profile,
           options):
    """Pre-pass + column program on flat (B, L) columns and (B,) parcels."""
    # --- per-parcel pre-pass: O(B) work, no (B, L) traffic ---
    lcls = lcl(p0, t0, td0)
    lcl_p = lcls['lcl_pressure']
    w0 = thermo.mixing_ratio(t0, td0, p0)
    fidx = adiabat.curve_index_integrate(lcl_p, lcls['lcl_temperature'])
    # The solve computes in the input dtype; wider tables (e.g. f64 test
    # tables against f32 data) must not promote the outputs.
    row = adiabat.blend_coeff_rows(tables, fidx).astype(p.dtype)
    # First-valid level index (leading-NaN prefix length of masked
    # sub-parcel columns).
    k0 = jnp.argmax(notnan(p), axis=-1)
    return _column_program(
        p, t, td, row, lcl_p, lcls['lcl_temperature'],
        lcls['lcl_virtual_temperature'], w0, t0, p0, k0,
        with_lifted_index=with_lifted_index, with_profile=with_profile,
        **dict(options))


def fused_cape_cin(pressure, temperature, dewpoint, parcel_pressure=None,
                   parcel_temperature=None, parcel_dewpoint=None,
                   tables=None, with_lifted_index=False, with_profile=False,
                   **kwargs):
    """CAPE/CIN for an arbitrary parcel via the fused column program.

    Drop-in for ``cape.cape_cin`` when only the CAPE/CIN numbers, LFC/EL
    (and optionally the lifted index) are needed — it does not return
    the profile unless ``with_profile``.  Parcel state defaults to the
    lowest level (surface-based).  Returns (res dict, solution dict) of
    (…) arrays matching the input batch shape.
    """
    if tables is None:
        tables = adiabat.default_tables()
    if getattr(tables, 'coeffs', None) is None:
        raise ValueError(
            'the fused solve needs spectral coefficients but '
            'tables.coeffs is None — rebuild the tables with '
            'AdiabatTables.build() or load_moist_adiabat_lookups()')
    p = jnp.asarray(pressure)
    t = jnp.asarray(temperature)
    td = jnp.asarray(dewpoint)
    # Batch shape from ALL inputs — environment columns AND parcel scalars
    # (a shared 1-D column with batched parcels is legal, as in
    # cape.cape_cin, and so is the reverse).
    env = jnp.broadcast_shapes(p.shape, t.shape, td.shape)
    batch_shape = jnp.broadcast_shapes(
        env[:-1], *(jnp.shape(x) for x in (parcel_pressure,
                                           parcel_temperature,
                                           parcel_dewpoint)
                    if x is not None))
    L = env[-1]
    full = batch_shape + (L,)
    p = jnp.broadcast_to(p, full).reshape((-1, L))
    t = jnp.broadcast_to(t, full).reshape((-1, L))
    td = jnp.broadcast_to(td, full).reshape((-1, L))

    def flat_scalar(x, default):
        if x is None:
            return default
        return jnp.broadcast_to(jnp.asarray(x), batch_shape).reshape((-1,))

    p0 = flat_scalar(parcel_pressure, p[:, 0])
    t0 = flat_scalar(parcel_temperature, t[:, 0])
    td0 = flat_scalar(parcel_dewpoint, td[:, 0])

    res, sol = _solve(p, t, td, p0, t0, td0, tables,
                      with_lifted_index=bool(with_lifted_index),
                      with_profile=bool(with_profile),
                      options=tuple(sorted(kwargs.items())))
    shape = lambda x: x.reshape(batch_shape + x.shape[1:])
    return jax.tree_util.tree_map(shape, (res, sol))


def fused_surface_cape_cin(pressure, temperature, dewpoint, **kwargs):
    """Surface-based CAPE/CIN via the fused column program
    (reference: modules/parcel_functions.py:1477-1514)."""
    return fused_cape_cin(pressure, temperature, dewpoint, **kwargs)
