"""Fixed-shape vertical level manipulation (level axis = -1).

The reference performs dynamic-shape level surgery with xarray reindexing:
``insert_level`` splices a per-column level (e.g. the LCL) into a sorted
profile via broadcast shift/fill (reference: modules/parcel_functions.py:
933-990), and ``shift_out_nans`` compacts leading NaNs with a Python loop of
whole-array shifts (:1699-1720).  Under jit both become static-shape gathers:
a column of L levels inserts into L+1 slots at a computed position, and
compaction is a per-column index offset.

Fields are dicts of arrays broadcastable to (…, L); per-column scalars are
(…).  NaN is the universal missing-value sentinel, and pressure acts as the
sort coordinate (strictly decreasing with level, NaNs trailing).
"""

import jax
import jax.numpy as jnp

from ._axis import axis_index, expander
from .interp import interp_many
from .reduce import nanmax, nanmin
from .safe import notnan


def _broadcast_fields(fields, coord='pressure'):
    """Broadcast all field arrays against each other to (…, L)."""
    shape = jnp.broadcast_shapes(*(jnp.shape(v) for v in fields.values()))
    return {k: jnp.broadcast_to(v, shape) for k, v in fields.items()}


def insert_level(fields, level, coord='pressure', lead=None, axis=-1):
    """Insert a per-column level into pressure-sorted profiles.

    ``fields``: dict of (…, L) arrays including ``coord``; ``level``: dict of
    (…) per-column values for (a subset of) the same keys, including
    ``coord``.  Returns a dict with keys of ``level`` and L+1 levels.

    Semantics match the reference exactly (reference:
    modules/parcel_functions.py:933-990):
      * levels with coord >= the new coord stay below it (so a duplicate of an
        existing coordinate is inserted *above* the existing one);
      * levels whose coord is NaN count as above (the reference's -999 fill)
        and all their variables come out NaN;
      * a NaN insertion coord floods the whole column with the level's values
        (all-NaN in practice).

    Columns may carry *leading* NaNs (a masked sub-parcel prefix, as produced
    by the parcel-subsetting wrappers): the insertion slot is offset past
    them, so the spliced column keeps its NaN prefix and stays sorted.
    ``lead`` optionally supplies that per-column leading-NaN count (the
    fused path computes it once and shares it with the LFC search).

    ``axis``: level axis, -1 (default) or 0 (level-major arrays (L, B),
    per-column values (B,)).
    """
    ex = expander(axis)
    fields = _broadcast_fields({k: fields[k] for k in level}, coord)
    p = fields[coord]
    pl = jnp.asarray(level[coord])
    L = p.shape[axis]
    dim = axis_index(axis, p.ndim)

    p_filled = jnp.where(jnp.isnan(p), -jnp.inf, p)
    if lead is None:
        lead = jnp.argmax(notnan(p), axis=axis)  # 0 if no/only lead NaN
    lead = jnp.asarray(lead).astype(jnp.int32)
    # Insertion slot = one past the LAST valid level with coord >= new (not
    # lead + count: an interior NaN-pressure slot between that level and
    # here would shift the count short and splice the new level below a
    # larger coordinate — an unsorted column whose area integration double
    # counts the inverted span).  Falls back to ``lead`` when no valid
    # level is >= (inserting above a leading-NaN prefix keeps the prefix).
    ii = jax.lax.broadcasted_iota(jnp.int32, p.shape, dim)
    valid_ge = p_filled >= ex(pl)
    idx = jnp.max(jnp.where(valid_ge, (ii + 1).astype(p.dtype), 0.0),
                  axis=axis).astype(jnp.int32)
    idx = jnp.maximum(idx, lead)                          # (…,) in [0, L]

    out_shape = p.shape[:dim] + (L + 1,) + p.shape[dim + 1:]
    j = jax.lax.broadcasted_iota(jnp.int32, out_shape, dim)
    below = j < ex(idx)                                         # (…, L+1)
    at = j == ex(idx)

    # out[j] = v[j] below the insertion, the level at it, v[j-1] above — two
    # static shifts + selects, no gather (this is the whole trick that
    # makes the splice free under XLA fusion).
    out = {}
    nan = jnp.full(p.shape[:dim] + (1,) + p.shape[dim + 1:], jnp.nan,
                   p.dtype)
    for k in level:
        v = fields[k]
        v_pad = jnp.concatenate([v, nan], axis=dim)      # v[j]
        v_prev = jnp.concatenate([nan, v], axis=dim)     # v[j-1]
        lvl = ex(jnp.asarray(level[k]))
        out[k] = jnp.where(below, v_pad, jnp.where(at, lvl, v_prev))

    # Variables at slots sourced from NaN-coordinate levels become NaN
    # (the reference's fill_value round-trip NaNs the whole slot).
    slot_nan = jnp.isnan(out[coord]) & ~at
    for k in out:
        if k != coord:
            out[k] = jnp.where(slot_nan, jnp.nan, out[k])

    # NaN insertion coordinate: reference floods the column with the level.
    flood = ex(jnp.isnan(pl))
    for k in out:
        out[k] = jnp.where(flood, ex(jnp.asarray(level[k])), out[k])
    return out


def compact_left(fields, key):
    """Shift every column left to drop its leading NaNs in ``fields[key]``.

    Vacated trailing slots are NaN.  Equivalent to the reference's
    ``shift_out_nans`` loop (reference: modules/parcel_functions.py:1699-1720)
    without the O(L) whole-array passes.  Non-float fields are promoted to
    float32 so the NaN fill is representable (xarray's ``shift`` promotes
    the same way; a 0-padded int would be indistinguishable from data —
    matches the host-side ``native.compact_left``).
    """
    fields = _broadcast_fields(fields)
    fields = {k: (v if jnp.issubdtype(v.dtype, jnp.floating)
                  else v.astype(jnp.float32))
              for k, v in fields.items()}
    v = fields[key]
    L = v.shape[-1]
    valid = notnan(v)
    lead = jnp.argmax(valid, axis=-1)                  # 0 if all-NaN (harmless)

    # Variable left-shift by binary decomposition: log2(L) static shifts with
    # per-column selects instead of a per-element gather.
    out = {k: arr for k, arr in fields.items()}
    shift, bit = lead, 0
    while (1 << bit) < L:
        step = 1 << bit
        take = ((shift >> bit) & 1).astype(bool)[..., None]
        for k, arr in out.items():
            pad = jnp.full(arr.shape[:-1] + (step,), jnp.nan, arr.dtype)
            shifted = jnp.concatenate([arr[..., step:], pad], axis=-1)
            out[k] = jnp.where(take, shifted, arr)
        bit += 1
    return out


def bound_pressure(pressure, bound):
    """Closest pressure level to ``bound``; ties take the larger pressure
    (reference: modules/parcel_functions.py:208-227)."""
    diffs = jnp.abs(pressure - jnp.asarray(bound)[..., None])
    min_diff = nanmin(diffs)
    return nanmax(pressure, where=diffs == min_diff[..., None])


def get_layer(fields, depth=100.0, interpolate=True, coord='pressure'):
    """Surface-based layer of the given pressure depth [hPa].

    With ``interpolate`` the layer top is log-interpolated and inserted as a
    new level (output has L+1 levels); otherwise the top snaps to the nearest
    existing level (output keeps L levels).  Levels outside the layer are
    NaN-masked (reference: modules/parcel_functions.py:63-100).
    """
    p = fields[coord]
    bottom = nanmax(p)

    if interpolate:
        top = bottom - depth
        # One shared anchor computation for every field (the anchor search
        # is ~8 masked reductions and dominates an interpolation's cost).
        # The coord itself is not interpolated — its level value IS ``top``.
        level = interp_many({k: v for k, v in fields.items() if k != coord},
                            p, top, log=True)
        level[coord] = top
        fields = insert_level(fields, level, coord=coord)
    else:
        top = bound_pressure(p, bottom - depth)
        fields = _broadcast_fields(fields)

    pnew = fields[coord]
    mask = (pnew <= bottom[..., None]) & (pnew >= top[..., None])
    return {k: jnp.where(mask, v, jnp.nan) for k, v in fields.items()}
