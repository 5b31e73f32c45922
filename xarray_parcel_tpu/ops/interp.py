"""Vertical interpolation primitives (level axis = -1).

Replaces, vectorised, two components of the reference:

* ``linear_interp`` / ``log_interp`` — duplicate-aware single-target
  interpolation along the vertical axis
  (reference: modules/parcel_functions.py:1758-1828), reproduced with
  identical selection rules (nearest enclosing coords, duplicate-coordinate
  averaging, exact-match passthrough, optional two-point extrapolation).

* ``interp1d`` — the reference's single native kernel, a numba ``guvectorize``
  per-column ``np.interp`` (reference: modules/parcel_functions.py:23-37),
  rebuilt as a vectorised searchsorted+gather that XLA fuses on device.  The
  moist-adiabat hot path does not even need this general form: its pressure
  grid is uniform, so interpolation reduces to index arithmetic
  (see adiabat.py).
"""

import jax.numpy as jnp

from ._axis import expander as _expander
from .reduce import nanmax, nanmin, nanmean
from .safe import notnan, safe_log


def interp_many(xs, coords, at, extrapolate=False, log=False,
                log_coords=None, axis=-1):
    """Interpolate SEVERAL (…, L) variables at one per-column target ``at``
    sharing one anchor computation (the anchor selection is ~8 masked
    reductions over the level axis — the dominant cost of an interpolation —
    and depends only on ``coords``/``at``, not on the values).

    ``xs``: dict/sequence of arrays.  Semantics per variable match
    ``linear_interp`` exactly.  Returns the same container type.
    ``log_coords``: optional precomputed ``log(coords)`` (hot-path threading;
    only used when ``log``).
    ``axis``: level axis, -1 (default, arrays (…, L)) or 0 (arrays (L, …);
    per-column scalars then broadcast against level-carrying arrays with
    no expansion).
    """
    ex = _expander(axis)
    if log:
        coords = log_coords if log_coords is not None else safe_log(coords)
        at = safe_log(jnp.asarray(at))
    at = jnp.asarray(at)
    atb = ex(at)

    coords_before = nanmin(coords, where=coords >= atb, axis=axis)
    coords_after = nanmax(coords, where=coords <= atb, axis=axis)

    if extrapolate:
        extrap_below = jnp.isnan(coords_before)
        extrap_above = jnp.isnan(coords_after)

        # Second largest / second smallest coordinate values (duplicate
        # min/max coords are ignored, as in the reference).
        cmax = nanmax(coords, axis=axis)
        cmin = nanmin(coords, axis=axis)
        second_lowest = nanmax(coords, where=coords != ex(cmax), axis=axis)
        second_highest = nanmin(coords, where=coords != ex(cmin), axis=axis)

        coords_before = jnp.where(extrap_below, coords_after, coords_before)
        coords_after = jnp.where(extrap_below, second_lowest, coords_after)

        coords_after = jnp.where(extrap_above, coords_before, coords_after)
        coords_before = jnp.where(extrap_above, second_highest, coords_before)

    mask_before = coords == ex(coords_before)
    mask_after = coords == ex(coords_after)
    # Guarded denominator: equal anchors take the passthrough branch below,
    # but an unguarded 0/0 (or NaN/NaN for out-of-range targets) would leak
    # NaN into reverse-mode cotangents of the masked-out branch.
    span = coords_after - coords_before
    span = jnp.where((span != 0) & notnan(span), span, 1.0)
    frac = (at - coords_before) / span

    def one(x):
        x_before = nanmean(x, where=mask_before, axis=axis)
        x_after = nanmean(x, where=mask_after, axis=axis)
        res = x_before + (x_after - x_before) * frac
        return jnp.where(x_before == x_after, x_before, res)

    if isinstance(xs, dict):
        return {k: one(v) for k, v in xs.items()}
    return type(xs)(one(v) for v in xs)


def linear_interp(x, coords, at, extrapolate=False):
    """Interpolate ``x`` (…, L) at per-column target ``at`` (…) given
    per-level ``coords`` (…, L).

    Matches the reference's semantics exactly:
      * anchor coords are the closest coord >= at and the closest <= at;
      * duplicate anchor coords average their values;
      * if both anchors have equal values the value passes through unchanged;
      * out-of-range targets give NaN unless ``extrapolate`` (then the two
        outermost distinct coords define the extrapolation line).
    """
    return interp_many((x,), coords, at, extrapolate=extrapolate)[0]


def log_interp(x, coords, at, extrapolate=False):
    """``linear_interp`` on log-transformed coordinates (log-pressure
    interpolation; reference: modules/parcel_functions.py:1813-1828)."""
    return interp_many((x,), coords, at, extrapolate=extrapolate, log=True)[0]


def interp1d(at, xp, fp):
    """Per-column linear interpolation, ``np.interp`` semantics.

    ``at``: query points (…, M); ``xp``: monotonically increasing knots
    (…, N); ``fp``: knot values (…, N).  Out-of-range queries clamp to the end
    values (np.interp default), NaN queries give NaN.  This is the
    vectorised equivalent of the reference's numba gufunc
    (reference: modules/parcel_functions.py:23-37, consumed at :585-592).
    """
    import jax

    batch = jnp.broadcast_shapes(at.shape[:-1], xp.shape[:-1], fp.shape[:-1])
    at = jnp.broadcast_to(at, batch + at.shape[-1:])
    xp = jnp.broadcast_to(xp, batch + xp.shape[-1:])
    fp = jnp.broadcast_to(fp, batch + fp.shape[-1:])
    flat_at = at.reshape((-1, at.shape[-1]))
    flat_xp = xp.reshape((-1, xp.shape[-1]))
    idx = jax.vmap(lambda a, v: jnp.searchsorted(a, v, side='left'))(
        flat_xp, flat_at).reshape(at.shape)
    hi = jnp.clip(idx, 1, xp.shape[-1] - 1)
    lo = hi - 1
    x0 = jnp.take_along_axis(xp, lo, axis=-1)
    x1 = jnp.take_along_axis(xp, hi, axis=-1)
    f0 = jnp.take_along_axis(fp, lo, axis=-1)
    f1 = jnp.take_along_axis(fp, hi, axis=-1)
    # NaN queries run on a safe finite dummy (t = 0) and the NaN pattern
    # is applied at the end: the raw (at - x0)/(x1 - x0) would leak NaN
    # into reverse-mode cotangents of fp even though the forward value is
    # masked (0 * NaN = NaN — the where-NaN gradient trap).
    safe_at = jnp.where(jnp.isnan(at), x0, at)
    t = (safe_at - x0) / (x1 - x0)
    out = f0 + t * (f1 - f0)
    # np.interp clamps outside the knot range.
    out = jnp.where(safe_at <= xp[..., :1], fp[..., :1], out)
    out = jnp.where(safe_at >= xp[..., -1:], fp[..., -1:], out)
    return jnp.where(jnp.isnan(at), jnp.nan, out)
