"""Trapezoidal vertical integration and zero-crossing rectangle areas.

Vectorised reformulation of the reference's ``trapz`` and
``trap_around_zeros`` (reference: modules/parcel_functions.py:164-206,
1200-1289), used by the CAPE/CIN integrator: the trapezoid sum covers whole
gaps, and rectangle areas are added around every zero crossing of the
parcel-environment temperature difference so buoyancy area is integrated
exactly up to the crossing, with a gap mask preventing double counting.

Everything is fixed-shape: a column of L levels has L-1 gaps; crossings are
indexed by gap and NaN-marked when absent.
"""

import jax.numpy as jnp

from ._axis import axis_index, edge_slicers
from .intersect import find_intersections
from .safe import notnan, safe_log


def gap_areas(y, x, axis=-1):
    """Per-gap trapezoid areas of ``y`` against ``x`` (no reduction).

    Returns ``(areas, valid)`` of shape (…, L-1): the |dx|·mean(y) area of
    each gap, and whether both of its endpoints are non-NaN in both arrays.
    Areas of invalid gaps are computed on zero dummies (finite, gradient-
    clean) and must be excluded by the caller's selection.

    Computing areas ONCE per track pair lets ``cape_cin_base`` integrate the
    CAPE and CIN windows as two masked sums over the same gap set instead of
    re-running the trapezoid arithmetic on two NaN-masked copies.
    """
    lo, hi = edge_slicers(axis)
    y0, y1 = lo(y), hi(y)
    x0, x1 = lo(x), hi(x)
    # Select-then-compute (not compute-then-NaN): gap areas touched by a
    # NaN level are excluded by the selection, and the arithmetic never sees
    # the NaN sentinels — keeps reverse-mode gradients finite.
    valid = notnan(y0) & notnan(y1) & notnan(x0) & notnan(x1)
    dx = jnp.abs(jnp.where(valid, x1 - x0, 0.0))
    means = 0.5 * (jnp.where(valid, y0, 0.0) + jnp.where(valid, y1, 0.0))
    return dx * means, valid


def select_areas(areas, valid, mask=None, only_positive=False,
                 only_negative=False, axis=-1):
    """Masked sum over a precomputed ``gap_areas`` set (trapz's back half)."""
    assert not (only_positive and only_negative)
    sel = valid if mask is None else (valid & mask)
    if only_positive:
        sel = sel & (areas > 0)
    if only_negative:
        sel = sel & (areas < 0)
    return jnp.sum(jnp.where(sel, areas, 0.0), axis=axis)


def trapz(y, x, mask=None, only_positive=False, only_negative=False,
          axis=-1):
    """NaN-skipping trapezoidal integral of ``y`` against ``x`` along the
    level axis (-1 by default, 0 for level-major arrays).

    ``mask`` (…, L-1) selects which gaps contribute; ``only_positive`` /
    ``only_negative`` keep only gaps whose area has that sign (used for the
    reference's pos-CAPE / neg-CIN convention,
    reference: modules/parcel_functions.py:194-206, 1358-1380).
    Matches xarray ``.sum`` semantics: NaN gaps are skipped, an empty
    selection integrates to 0.
    """
    areas, valid = gap_areas(y, x, axis=axis)
    return select_areas(areas, valid, mask=mask, only_positive=only_positive,
                        only_negative=only_negative, axis=axis)


def trap_around_zeros(x, y, log_x=True, start=0, intersections=None,
                      log_x_values=None, axis=-1):
    """Rectangle areas hugging each zero crossing of ``y`` along ``x``.

    ``intersections``: optional precomputed crossing set for the SAME curves
    (``find_intersections(x, a, b, log_x)`` where ``y = a - b``), valid only
    with ``start=0`` — lets the CAPE path reuse the LFC/EL solver's
    crossings instead of recomputing them.

    For every gap with a zero crossing of ``y``, two rectangles are produced:
    one between the level *before* the crossing and the crossing, and one
    between the crossing and the level *after* — each with height y/2 at the
    bounding level (mean of y and 0), mirroring the reference's
    ``calc_areas`` (reference: modules/parcel_functions.py:1246-1273).

    Returns ``(areas, gap_mask)``:
      * areas: dict with 'area', 'x', 'dx', 'x_from', 'x_to', each
        (…, 2*(L-start-1)) — the before-rectangles then the after-rectangles,
        NaN where no crossing.  Positions are in log-x space when ``log_x``
        (the caller exponentiates, as the reference's cape_cin_base does).
      * gap_mask: (…, L-1) boolean — False for gaps containing a crossing,
        for use as the trapz mask (no double counting).

    ``axis``: level axis, -1 (default) or 0 (level-major arrays; ``start``
    must then be 0).
    """
    assert axis == -1 or start == 0, 'start requires the default level axis'
    lo, hi = edge_slicers(axis)
    xs = x[..., start:] if start else x
    ys = y[..., start:] if start else y

    if log_x:
        if log_x_values is not None:
            xl = log_x_values[..., start:] if start else log_x_values
        else:
            xl = safe_log(xs)
    else:
        xl = xs

    if intersections is not None:
        assert start == 0, 'precomputed intersections require start=0'
        ints = intersections
    else:
        # Thread the already-computed log(x) through — a duplicated
        # per-level safe_log would fatten every trace.
        ints = find_intersections(xs, ys, jnp.zeros_like(ys), log_x=log_x,
                                  log_x_values=xl if log_x else None,
                                  axis=axis)
    if log_x:
        zx = ints.get('all_logx')
        if zx is None:
            zx = safe_log(ints['all_x'])
    else:
        zx = ints['all_x']
    crossing = notnan(ints['all_x'])

    # Safe crossing positions for the arithmetic below: NaN positions
    # (no crossing / poisoned gaps / NaN-padded levels) would otherwise leak
    # NaN into reverse-mode cotangents of the (masked-out) rectangle areas.
    zx_safe = jnp.where(crossing & notnan(zx), zx, 0.0)

    def rects(point_x, point_y):
        keep = (crossing & notnan(zx) & notnan(point_y) &
                notnan(point_x))
        px = jnp.where(keep, point_x, 0.0)
        dx = px - zx_safe
        y_safe = jnp.where(keep, point_y, 0.0)
        # * 0.5, not / 2.0: bit-identical, and a multiply is cheaper.
        area = (y_safe * 0.5) * jnp.abs(dx)
        pos = px - dx * 0.5
        return (jnp.where(keep, area, jnp.nan),
                jnp.where(keep, pos, jnp.nan),
                jnp.where(keep, jnp.abs(dx), jnp.nan))

    # Before-rectangles anchor at level k of gap k; after-rectangles at k+1.
    area_b, pos_b, dx_b = rects(lo(xl), lo(ys))
    area_a, pos_a, dx_a = rects(hi(xl), hi(ys))

    dim = axis_index(axis, area_b.ndim)
    area = jnp.concatenate([area_b, area_a], axis=dim)
    pos = jnp.concatenate([pos_b, pos_a], axis=dim)
    dx = jnp.concatenate([dx_b, dx_a], axis=dim)

    areas = {
        'area': area,
        'x': pos,
        'dx': dx,
        'x_from': pos - dx * 0.5,
        'x_to': pos + dx * 0.5,
    }

    # Gaps before ``start`` always contribute to the trapezoid sum.
    if start:
        full = jnp.broadcast_shapes(x.shape, y.shape)
        lead = jnp.broadcast_to(jnp.asarray(True), full[:-1] + (start,))
        gap_mask = jnp.concatenate([lead, ~crossing], axis=-1)
    else:
        gap_mask = ~crossing
    assert gap_mask.shape[axis] == x.shape[axis] - 1
    return areas, gap_mask
