"""Piecewise-linear curve intersection finder (level axis = -1).

Vectorised reformulation of the reference's ``find_intersections``
(reference: modules/parcel_functions.py:992-1064).  The reference builds the
crossing set with xarray shift/concat index gymnastics; here each potential
crossing lives in gap k (between levels k and k+1), giving fixed-shape
(…, L-1) outputs with NaN marking "no crossing" — directly consumable by the
NaN-aware reductions in the LFC/EL solver.
"""

import jax.numpy as jnp

from ._axis import edge_slicers
from .safe import notnan, safe_exp, safe_log


def find_intersections(x, a, b, log_x=False, log_x_values=None,
                       log_outputs=False, axis=-1):
    """Find crossings of curves ``a`` and ``b`` sharing coords ``x`` (…, L).

    Returns a dict of (…, L-1) arrays: ``all_x``/``all_y`` (every crossing),
    ``increasing_x``/``increasing_y`` (a crosses above b) and
    ``decreasing_x``/``decreasing_y``.  Entry k describes the crossing in gap
    (k, k+1); NaN where there is none.  Matches the reference's convention of
    reporting the crossing at the *after* index, including its handling of
    exact touches (sign hits 0) and NaN-poisoned gaps.

    Hot-path threading: ``log_x_values`` supplies a precomputed ``log(x)``
    (saving the transcendental), and ``log_outputs=True`` keeps every ``*_x``
    output in LOG space — order/NaN-pattern identical, no per-gap ``exp`` —
    for consumers that only compare positions (lfc_el / cape_cin_base with
    ``intersections_in_log=True``).

    ``axis``: level axis, -1 (default) or 0 (level-major arrays); gap entry
    k then lives at index k of that axis.
    """
    lo, hi = edge_slicers(axis)
    if log_x:
        x = log_x_values if log_x_values is not None else safe_log(x)

    sign = jnp.sign(a - b)
    s0 = lo(sign)
    s1 = hi(sign)
    # A NaN sign difference is treated as a crossing by the reference
    # (diffs.where(diffs == 0, other=1) maps NaN -> 1); the algebra below then
    # yields NaN coordinates, which downstream reductions skip — identical
    # net behaviour, so a plain != (True for NaN pairs) reproduces it.
    crossing = s0 != s1

    x0, x1 = lo(x), hi(x)
    a0, a1 = lo(a), hi(a)
    b0, b1 = lo(b), hi(b)

    delta_y0 = a0 - b0
    delta_y1 = a1 - b1
    # Gaps touching a NaN level (pad/poisoned data) must emit NaN crossings,
    # but the arithmetic below must never SEE those NaNs: a product/quotient
    # with a NaN forward value leaks NaN into reverse-mode cotangents even
    # when its own cotangent is zero (the where-NaN gradient trap).  So
    # compute on safe finite dummies and re-impose the NaN pattern after.
    finite = (crossing & notnan(delta_y0) & notnan(delta_y1) &
              notnan(x0) & notnan(x1))
    d0 = jnp.where(finite, delta_y0, 0.0)
    d1 = jnp.where(finite, delta_y1, 1.0)
    xs0 = jnp.where(finite, x0, 0.0)
    xs1 = jnp.where(finite, x1, 1.0)
    as0 = jnp.where(finite & notnan(a0), a0, 0.0)
    as1 = jnp.where(finite & notnan(a1), a1, 0.0)
    # Guarded denominators (0/0 in exact-touch gaps is the same trap).
    dy = d1 - d0
    dy = jnp.where(finite & (dy != 0), dy, 1.0)
    dx = xs1 - xs0
    dx = jnp.where(finite & (dx != 0), dx, 1.0)
    intersect_x = (d1 * xs0 - d0 * xs1) / dy
    intersect_y = ((intersect_x - xs0) / dx) * (as1 - as0) + as0
    # Duplicate-coordinate gaps keep the unguarded algebra's NaN y.
    intersect_y = jnp.where(x1 != x0, intersect_y, jnp.nan)

    nan = jnp.nan
    intersect_x = jnp.where(finite, intersect_x, nan)
    intersect_y = jnp.where(finite & notnan(a0) & notnan(a1),
                            intersect_y, nan)

    if log_x and not log_outputs:
        out_x = safe_exp(intersect_x)
    else:
        out_x = intersect_x

    # Direction of the crossing, evaluated at the after point (reference
    # :1030-1031): sign(a1 - b1) where a crossing occurred.
    sign_change = jnp.where(crossing, s1, nan)

    inc = sign_change > 0
    dec = sign_change < 0
    out = {
        'all_x': out_x,
        'all_y': intersect_y,
        'increasing_x': jnp.where(inc, out_x, nan),
        'increasing_y': jnp.where(inc, intersect_y, nan),
        'decreasing_x': jnp.where(dec, out_x, nan),
        'decreasing_y': jnp.where(dec, intersect_y, nan),
    }
    if log_x:
        # Log-space positions, so consumers that work in log space
        # (trap_around_zeros) need not re-log the exp'd output.
        out['all_logx'] = intersect_x
    return out
