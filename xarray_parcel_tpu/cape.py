"""LFC/EL solver and CAPE/CIN integration.

Vectorised equivalents of the reference's convection solvers
(reference: modules/parcel_functions.py:1066-1515).  All selection logic is
expressed as NaN-aware masked reductions over the fixed-length crossing set,
reproducing the reference's rules exactly:

* LFC = bottom-most (highest-pressure) increasing parcel/environment crossing
  above the LCL, with USAF1990 LCL-substitution rules;
* EL = top-most (lowest-pressure) decreasing crossing, which must be above
  the LCL and requires the parcel to be colder than the environment at the
  top of the sounding;
* CAPE/CIN = Rd * trapezoid of (T_parcel - T_env) d ln p between LFC→EL and
  surface→LFC, with exact rectangle areas added around buoyancy
  zero-crossings and a gap mask preventing double counting;
* the virtual-temperature correction (reference's recommended default) picks
  the virtual-temperature track for both parcel and environment.
"""

import jax
import jax.numpy as jnp

from . import constants as c
from .ops import (find_intersections, nanmax, nanmin, nansum, notnan,
                  safe_exp,
                  safe_log, trap_around_zeros)
from .ops._axis import axis_index, edge_slicers, expander
from .ops.integrate import gap_areas, select_areas
from .profile import parcel_profile_with_lcl


def lfc_el(pressure, parcel_temperature, temperature, lcl_pressure,
           lcl_temperature, intersections=None, log_pressure=None,
           log_lcl_pressure=None, intersections_in_log=False,
           first_valid=None, axis=-1):
    """Level of free convection and equilibrium level.

    Inputs are (…, L) profile tracks (already including the LCL level when
    called from cape_cin) and (…) LCL state.  Returns dict with
    lfc_pressure/lfc_temperature/el_pressure/el_temperature
    (reference: modules/parcel_functions.py:1066-1198).
    ``intersections``: optional precomputed
    ``find_intersections(p, pt, t, log_x=True)`` (shared with the CAPE
    integrator by ``cape_cin``).  When the shared set was built with
    ``log_outputs=True``, pass ``intersections_in_log=True`` (and ideally
    the precomputed ``log_pressure``): all pressure comparisons then run in
    log space — same order, same NaN pattern, zero per-level transcendentals
    — and only the two scalar outputs are exponentiated.

    ``axis``: level axis, -1 (default) or 0 (level-major arrays).
    """
    ex = expander(axis)
    p = jnp.asarray(pressure)
    pt = jnp.asarray(parcel_temperature)
    t = jnp.asarray(temperature)
    p, pt, t = jnp.broadcast_arrays(p, pt, t)
    lcl_p = jnp.asarray(lcl_pressure)
    lcl_t = jnp.asarray(lcl_temperature)

    if intersections_in_log:
        # Work entirely in log-pressure: log is monotone, so every order
        # comparison below is unchanged; outputs are exp'd at the end.
        # Both logs accept precomputed values: the fused solve already
        # holds them, so no duplicate per-level log is traced.
        pw = (log_pressure if log_pressure is not None else
              safe_log(p))
        lclw = (jnp.asarray(log_lcl_pressure)
                if log_lcl_pressure is not None else safe_log(lcl_p))
    else:
        pw, lclw = p, lcl_p

    # A self-built crossing set must live in the SAME space as the window
    # comparisons below: with ``intersections_in_log`` every crossing x is
    # compared against log-pressure scalars, so the set is built with
    # ``log_outputs=True`` (a linear-x set here would silently cross units).
    ints = (intersections if intersections is not None else
            find_intersections(
                p, pt, t, log_x=True,
                log_x_values=pw if intersections_in_log else None,
                log_outputs=intersections_in_log, axis=axis))

    # Crossing set ignoring the first level: identical except gap 0 is
    # unavailable (reference recomputes on a slice and reindexes :1107-1112).
    # Only the four consumed entries are materialised (one select each —
    # cheaper than rebuilding the whole six-entry dict by concatenation).
    # "First level" means the first level with a valid pressure: columns may
    # carry a leading-NaN prefix (levels below the launched parcel, masked by
    # the parcel-subsetting wrappers instead of compacted away — the
    # reference shifts these out, reference :1552-1553, which here would
    # cost a per-column shift network; an index offset is free).
    # ``first_valid`` optionally supplies the index (the fused path
    # computes it once and shares it with the LCL splice).
    if first_valid is None:
        first_valid = jnp.argmax(notnan(p), axis=axis)
    k0 = ex(jnp.asarray(first_valid).astype(jnp.int32))
    gaps = ints['increasing_x'].shape
    gap0 = jax.lax.broadcasted_iota(jnp.int32, gaps,
                                    axis_index(axis, len(gaps))) == k0
    # Where parcel and environment share the exact first-level value, use the
    # crossing set that ignores that point (reference :1114-1120).
    at_k0 = jax.lax.broadcasted_iota(jnp.int32, p.shape,
                                     axis_index(axis, p.ndim)) == k0
    t0 = nanmax(t, where=at_k0, axis=axis)
    pt0 = nanmax(pt, where=at_k0, axis=axis)
    # Ulp-scaled equality (the reference compares exactly, :1117-1120): the
    # fused path computes the parcel's first-level track partly in the
    # per-parcel pre-pass while the environment's comes from the column
    # program, so "the same value" can differ by a few ulps between the
    # two fusions.
    # 8 ulps is ~3e-4 K in fp32 production and ~5e-13 K in the f64 test
    # mode (i.e. effectively the reference's exact equality there); NaN
    # first levels compare unequal either way.
    tol = (8.0 * jnp.finfo(t.dtype).eps
           * jnp.maximum(jnp.abs(t0), jnp.abs(pt0)))
    same_first = ex(jnp.abs(t0 - pt0) <= tol)
    drop_inc = gap0 & same_first
    inc_x = jnp.where(drop_inc, jnp.nan, ints['increasing_x'])
    inc_y = jnp.where(drop_inc, jnp.nan, ints['increasing_y'])
    dec_x_above = jnp.where(gap0, jnp.nan, ints['decreasing_x'])
    dec_y_above = jnp.where(gap0, jnp.nan, ints['decreasing_y'])

    # LFC: bottom-most increasing crossing above the LCL.
    above_lcl = inc_x < ex(lclw)
    lfc_p = nanmax(inc_x, where=above_lcl, axis=axis)
    lfc_t = nanmax(inc_y, where=inc_x == ex(lfc_p), axis=axis)

    # EL: top-most decreasing crossing (always from the above-first set;
    # the temperature match must use the SAME set, else a gap-0 decreasing
    # crossing with same_first=False could match the wrong y).
    el_p = nanmin(dec_x_above, axis=axis)
    el_t = nanmax(dec_y_above, where=dec_x_above == ex(el_p), axis=axis)

    # EL existence: parcel colder than environment at the top of the sounding
    # and EL above the LCL (reference :1141-1155).
    temps_available = notnan(pt) & notnan(t)
    top_p = nanmin(pw, where=temps_available, axis=axis)
    at_top = pw == ex(top_p)
    top_prof = nanmax(pt, where=at_top, axis=axis)
    top_env = nanmax(t, where=at_top, axis=axis)
    el_exists = (top_prof <= top_env) & (el_p < lclw)
    el_p = jnp.where(el_exists, el_p, jnp.nan)
    el_t = jnp.where(el_exists, el_t, jnp.nan)

    # LCL substitution rules (USAF1990; reference :1160-1185).
    lfc_missing = jnp.isnan(nanmax(inc_x, axis=axis))
    above = pw < ex(lclw)
    # (pt > t is False for NaN pairs, so plain & matches the reference's
    # where().any() without a boolean select.)
    pos_parcel = jnp.any(above & (pt > t), axis=axis)
    no_lfc_pos_parcel = pos_parcel & lfc_missing

    exists_but_na = ~lfc_missing & jnp.isnan(lfc_p)
    lfc_below_el_above = exists_but_na & (el_p < lclw)

    replace_with_lcl = no_lfc_pos_parcel | lfc_below_el_above

    extra = {}
    if intersections_in_log:
        # Log-space LFC/EL threaded to cape_cin_base under private keys so
        # its window comparisons never pay (or wobble through) an exp->log
        # round trip; callers pop them before returning sol to users.
        extra['_lfc_log_pressure'] = jnp.where(replace_with_lcl, lclw, lfc_p)
        extra['_el_log_pressure'] = el_p
        lfc_p = safe_exp(lfc_p)
        el_p = safe_exp(el_p)
    lfc_p = jnp.where(replace_with_lcl, lcl_p, lfc_p)
    lfc_t = jnp.where(replace_with_lcl, lcl_t, lfc_t)

    return {'lfc_pressure': lfc_p, 'lfc_temperature': lfc_t,
            'el_pressure': el_p, 'el_temperature': el_t, **extra}


def cape_cin_base(pressure, temperature, lfc_pressure, el_pressure,
                  parcel_temperature, pos_cape_neg_cin=True,
                  post_zero_cin=False, intersections=None,
                  log_pressure=None, log_lfc_pressure=None,
                  log_el_pressure=None, axis=-1):
    """CAPE and CIN from a parcel track and LFC/EL pressures.

    (reference: modules/parcel_functions.py:1291-1392).  ``pos_cape_neg_cin``
    counts only positive (negative) buoyancy toward CAPE (CIN) — the
    reference's deliberate deviation from MetPy; ``post_zero_cin`` clamps
    positive CIN to zero (MetPy-style).

    All pressure-window comparisons run in log space (log is monotone, so
    the selections are identical) against the per-column ``log(lfc)`` /
    ``log(el)`` scalars — no per-level/per-gap transcendentals beyond the
    single ``log(pressure)`` (itself skippable via ``log_pressure``).
    """
    ex = expander(axis)
    p = jnp.asarray(pressure)
    t = jnp.asarray(temperature)
    pt = jnp.asarray(parcel_temperature)
    p, t, pt = jnp.broadcast_arrays(p, t, pt)
    log_p = log_pressure if log_pressure is not None else safe_log(p)
    lfc_lp = ex(jnp.asarray(log_lfc_pressure)
                if log_lfc_pressure is not None
                else safe_log(lfc_pressure))

    # Missing EL -> top of sounding (reference :1329-1330).
    el = (jnp.asarray(log_el_pressure) if log_el_pressure is not None
          else safe_log(el_pressure))
    el_lp = ex(jnp.where(jnp.isnan(el), nanmin(log_p, axis=axis), el))

    diff = pt - t

    areas, gap_mask = trap_around_zeros(p, diff, log_x=True, start=0,
                                        intersections=intersections,
                                        log_x_values=log_p, axis=axis)
    area_x = areas['x']                        # log-pressure positions
    area = areas['area']

    # Trapezoid areas computed ONCE from the unmasked tracks; the CAPE and
    # CIN windows then select gaps whose BOTH endpoints lie in-window —
    # identical to trapz over the NaN-masked copies (a gap survived that
    # masking iff both endpoints were in-window and non-NaN) at half the
    # per-level arithmetic.
    lo, hi = edge_slicers(axis)
    t_area, t_valid = gap_areas(diff, log_p, axis=axis)

    # CAPE: positive buoyancy between LFC and EL.
    in_cape = (log_p <= lfc_lp) & (log_p >= el_lp)
    a_cape = (area_x <= lfc_lp) & (area_x >= el_lp)
    if pos_cape_neg_cin:
        a_cape = a_cape & (area > 0)
    cape = c.Rd * select_areas(t_area, t_valid & lo(in_cape) & hi(in_cape),
                               mask=gap_mask,
                               only_positive=pos_cape_neg_cin, axis=axis)
    cape = cape + c.Rd * nansum(area, where=a_cape, axis=axis)

    # CIN: negative buoyancy between surface and LFC.
    in_cin = log_p >= lfc_lp
    a_cin = area_x >= lfc_lp
    if pos_cape_neg_cin:
        a_cin = a_cin & (area < 0)
    cin = c.Rd * select_areas(t_area, t_valid & lo(in_cin) & hi(in_cin),
                              mask=gap_mask,
                              only_negative=pos_cape_neg_cin, axis=axis)
    cin = cin + c.Rd * nansum(area, where=a_cin, axis=axis)

    if post_zero_cin:
        cin = jnp.where(cin <= 0, cin, 0.0)

    return {'cape': cape, 'cin': cin}


def cape_cin(pressure, temperature, dewpoint, parcel_temperature,
             parcel_pressure, parcel_dewpoint,
             virtual_temperature_correction=True, lcl_interp='log',
             tables=None, moist_lapse=None, **kwargs):
    """Full CAPE/CIN: profile with LCL -> LFC/EL -> integration.

    Returns (cape_cin dict, merged profile dict).  The virtual-temperature
    correction (default on, the reference's recommended deviation from MetPy
    <= 1.4.1; reference: modules/parcel_functions.py:1394-1475) runs the
    LFC/EL search and integration on the virtual-temperature tracks.
    """
    profile = parcel_profile_with_lcl(
        pressure, temperature, dewpoint, parcel_pressure,
        parcel_temperature, parcel_dewpoint, lcl_interp=lcl_interp,
        tables=tables, moist_lapse=moist_lapse)

    if virtual_temperature_correction:
        parcel_track = profile['virtual_temperature']
        env_track = profile['environment_virtual_temperature']
        lcl_track_t = profile['lcl_virtual_temperature']
    else:
        parcel_track = profile['temperature']
        env_track = profile['environment_temperature']
        lcl_track_t = profile['lcl_temperature']

    # One crossing set serves both the LFC/EL selection and the exact-area
    # integration (the curves are identical: zero crossings of
    # parcel - env are crossings of parcel vs env).  ln(p) is computed once
    # and threaded through intersections, selection and integration; the
    # crossing set stays in log space end to end (no per-gap exp).
    pp, ptr, env = jnp.broadcast_arrays(profile['pressure'], parcel_track,
                                        env_track)
    lp = safe_log(pp)
    ints = find_intersections(pp, ptr, env, log_x=True, log_x_values=lp,
                              log_outputs=True)
    sol = lfc_el(profile['pressure'], parcel_track, env_track,
                 profile['lcl_pressure'], lcl_track_t, intersections=ints,
                 log_pressure=lp, intersections_in_log=True)
    res = cape_cin_base(profile['pressure'], env_track,
                        sol['lfc_pressure'], sol['el_pressure'],
                        parcel_track, intersections=ints, log_pressure=lp,
                        log_lfc_pressure=sol.pop('_lfc_log_pressure'),
                        log_el_pressure=sol.pop('_el_log_pressure'),
                        **kwargs)
    merged = dict(profile)
    merged.update(sol)
    return res, merged


def surface_based_cape_cin(pressure, temperature, dewpoint, **kwargs):
    """CAPE/CIN for a parcel launched from the lowest level
    (reference: modules/parcel_functions.py:1477-1514)."""
    pressure = jnp.asarray(pressure)
    temperature = jnp.asarray(temperature)
    dewpoint = jnp.asarray(dewpoint)
    return cape_cin(pressure, temperature, dewpoint,
                    parcel_temperature=temperature[..., 0],
                    parcel_pressure=pressure[..., 0],
                    parcel_dewpoint=dewpoint[..., 0], **kwargs)
