"""Level-axis helpers for axis-general column ops.

Every vertical op in this package operates along a level axis that is either
-1 (the library-wide default: arrays are (…, L), per-column scalars (…)) or
0 (level-major arrays (L, …)).

With ``axis == 0`` a per-column scalar of shape (…) broadcasts natively
against a level-carrying (L, …) array, so scalar expansion is the identity;
with ``axis == -1`` it is ``s[..., None]``.  These helpers keep that branch
in one place.
"""


def expander(axis):
    """Per-column-scalar -> broadcastable-against-levels expansion."""
    if axis == -1:
        return lambda s: s[..., None]
    assert axis == 0, 'level axis must be -1 or 0'
    return lambda s: s


def edge_slicers(axis):
    """(drop-last, drop-first) slicers along the level axis."""
    if axis == -1:
        return (lambda v: v[..., :-1]), (lambda v: v[..., 1:])
    assert axis == 0, 'level axis must be -1 or 0'
    return (lambda v: v[:-1]), (lambda v: v[1:])


def axis_index(axis, ndim):
    """Non-negative dimension index of the level axis."""
    return ndim - 1 if axis == -1 else 0
