"""Generic vertical-column array ops (the reference's L2 layer, vectorised).

All ops act along the last axis (the vertical level axis), are fixed-shape,
NaN-aware, and jit/vmap-safe.
"""

from .reduce import nanmax, nanmin, nansum, nanmean, nancount, any_valid
from .safe import notnan, safe_log, safe_exp
from .interp import interp_many, linear_interp, log_interp, interp1d
from .intersect import find_intersections
from .integrate import gap_areas, select_areas, trapz, trap_around_zeros
from .levels import insert_level, compact_left, bound_pressure, get_layer

__all__ = [
    'nanmax', 'nanmin', 'nansum', 'nanmean', 'nancount', 'any_valid',
    'notnan', 'safe_log', 'safe_exp',
    'interp_many', 'linear_interp', 'log_interp', 'interp1d',
    'find_intersections', 'gap_areas', 'select_areas', 'trapz',
    'trap_around_zeros',
    'insert_level', 'compact_left', 'bound_pressure', 'get_layer',
]
