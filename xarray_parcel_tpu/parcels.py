"""Parcel selection: mixed-layer and most-unstable parcels, plus the
corresponding CAPE/CIN wrappers.

Vectorised equivalents of reference: modules/parcel_functions.py:102-289
(layer mixing, most-unstable search) and :1517-1697 (subsetting wrappers).
The reference's variable-length subsetting (``dropna`` + ``shift_out_nans``)
becomes fixed-shape left-compaction: columns keep a static level count with
NaN padding at the top, which every downstream op already treats as missing.
"""

import jax
import jax.numpy as jnp

from . import thermo
from .cape import cape_cin
from .ops import get_layer, insert_level, interp_many, nanmax, notnan


def bridge_neighbors(pressure, valid):
    """Previous/next valid pressure of every level (exclusive cumulative
    min/max scans along the level axis; pressures sorted decreasing).

    ``+inf``/``-inf`` mark "no previous"/"no next".  Depth-independent —
    compute once and pass to :func:`mixed_layer` via ``neighbors=`` when
    mixing several depths of the same columns (each scan pair costs ~7
    full-field passes; the pipeline shares one pair across both conserved
    variables and both mixing depths, benchmarks/prep_breakdown.py).
    """
    axis = pressure.ndim - 1
    run_min = jax.lax.cummin(jnp.where(valid, pressure, jnp.inf), axis=axis)
    prev_raw = jnp.concatenate(
        [jnp.full_like(run_min[..., :1], jnp.inf), run_min[..., :-1]],
        axis=-1)
    run_max = jax.lax.cummax(jnp.where(valid, pressure, -jnp.inf),
                             axis=axis, reverse=True)
    next_raw = jnp.concatenate(
        [run_max[..., 1:], jnp.full_like(run_max[..., :1], -jnp.inf)],
        axis=-1)
    return prev_raw, next_raw


def mixed_layer(fields, depth=100.0, valid=None, neighbors=None):
    """Mass-weighted (mean-value-theorem) average of each variable over the
    surface-based layer of the given depth
    (reference: modules/parcel_functions.py:137-162).

    Direct per-gap integration: trapezoid gaps between consecutive valid
    in-layer levels, plus a partial boundary gap from the last valid
    in-layer level to the log-interpolated layer top — the same integral
    dropna + ``trapz`` over the layer computes, without materialising a
    spliced (…, L+1) column (the splice costs ~25 full-field passes).

    Interior-NaN levels are BRIDGED: a gap whose endpoints are the valid
    levels on either side of a NaN run is integrated with those endpoint
    values (the piecewise-linear interpolant through the observed points —
    what the serial oracle's dropna-then-trapezoid computes).  The
    reference's splice instead duplicates the inserted top level at
    every NaN slot (insert_level's fill_value round-trip, reference
    :960-990), leaving an unsorted pressure column whose rolling-trapz
    double-counts overlapping spans — deviating here is deliberate.

    ``valid``: optional shared level-validity mask.  Default (None) is
    per-variable validity (``isfinite(p) & isfinite(v)``), each variable
    bridging its own NaN levels.  With ``valid`` given, all variables mix
    over the SAME jointly-valid level set (whole-level dropna — the
    pipeline passes ``isfinite(p & t & td)``), which lets the scan pair be
    shared; the caller guarantees every variable is finite where ``valid``
    (a violation surfaces as NaN output, never silent misintegration).
    ``neighbors``: optional precomputed :func:`bridge_neighbors` for that
    shared mask.

    Implementation is gather-free: with ``prev``/``next`` the neighbouring
    valid pressures of each level, the bridged trapezoid sum telescopes to
    ``0.5 * sum_i v_i * (prev_i - next_i)`` (one-sided at the run ends;
    the layer-top restriction is a clip on ``next`` — a valid level's
    previous valid level is automatically in-layer on sorted columns).
    """
    p = fields['pressure']
    vals = {k: v for k, v in fields.items() if k != 'pressure'}
    bottom = nanmax(p)
    top = bottom - depth
    topb = top[..., None]

    valid_p = notnan(p)
    j = jax.lax.broadcasted_iota(jnp.int32, p.shape, p.ndim - 1)

    # NaN top (all-NaN column) must not enter the boundary arithmetic: the
    # masked-out branch of a multiply still poisons reverse-mode cotangents
    # (the where-NaN trap); the NaN pattern comes from the span instead.
    safe_top = jnp.where(jnp.isnan(top), 0.0, top)
    safe_bottom = jnp.where(jnp.isnan(bottom), 0.0, bottom)

    shared = valid is not None
    if shared:
        valid = valid & valid_p
        if neighbors is None:
            neighbors = bridge_neighbors(p, valid)
        m_shared = valid & (p >= topb)
        k_star_s = jnp.max(jnp.where(m_shared, j, -1), axis=-1)
        at_k_s = (j == k_star_s[..., None]) & m_shared
        p_k_s = jnp.sum(jnp.where(at_k_s, p, 0.0), axis=-1)
        any_k_s = jnp.any(at_k_s, axis=-1)
        # Top anchors skip INVALID levels (masked pressure): a NaN value at
        # a valid-pressure anchor must bridge to the nearest valid level,
        # not zero the whole boundary gap.  Shared mode keeps one shared
        # anchor computation for all variables.
        p_anchor = jnp.where(valid, p, jnp.nan)
        f_top = interp_many(vals, p_anchor, top, log=True)

    out = {}
    for k, v in vals.items():
        if shared:
            m, (prev_raw, next_raw) = m_shared, neighbors
            at_k, p_k, any_k = at_k_s, p_k_s, any_k_s
            ft = f_top[k]
        else:
            vv = valid_p & notnan(v)
            prev_raw, next_raw = bridge_neighbors(p, vv)
            m = vv & (p >= topb)
            # Last valid in-layer level: the boundary gap's lower endpoint.
            k_star = jnp.max(jnp.where(m, j, -1), axis=-1)
            at_k = (j == k_star[..., None]) & m   # all-False if k_star==-1
            p_k = jnp.sum(jnp.where(at_k, p, 0.0), axis=-1)
            any_k = jnp.any(at_k, axis=-1)
            # Per-variable masked anchors (this variable's own valid set).
            ft = interp_many({k: v}, jnp.where(vv, p, jnp.nan), top,
                             log=True)[k]

        p_own = jnp.where(m, p, 0.0)         # finite dummies throughout
        v_own = jnp.where(m, v, 0.0)
        # +inf = "no previous" -> one-sided (own p).  A next level below
        # the layer top is the boundary gap's job -> also one-sided.
        prev_p = jnp.where(m & jnp.isfinite(prev_raw), prev_raw, p_own)
        next_p = jnp.where(m & (next_raw >= topb), next_raw, p_own)

        inner = 0.5 * jnp.sum(v_own * (prev_p - next_p), axis=-1)

        # Boundary gap: last valid in-layer level -> interpolated top.
        f_k = jnp.sum(jnp.where(at_k, v, 0.0), axis=-1)
        b_ok = any_k & notnan(ft)
        b_area = (0.5 * (f_k + jnp.where(b_ok, ft, 0.0))
                  * jnp.abs(p_k - safe_top))
        # Mean-value denominator: the span the integral ACTUALLY covers —
        # first valid in-layer level down to the interpolated top (= the
        # requested depth when the bottom level itself is valid), else to
        # the last valid in-layer level (the reference divides by the
        # retrieved layer's span, :157-162 — a column whose bottom levels
        # are missing averages over what exists rather than biasing low).
        # No valid in-layer level at all -> NaN, never a silent 0.
        p_first = jnp.max(p_own, axis=-1)    # 0 when nothing valid in-layer
        span = jnp.where(b_ok,
                         jnp.where(p_first == safe_bottom, depth,
                                   p_first - safe_top),
                         p_first - p_k)
        inv = jnp.where(any_k & (span > 0), 1.0 / jnp.where(span > 0, span,
                                                            1.0), jnp.nan)
        out[k] = (inner + jnp.where(b_ok, b_area, 0.0)) * inv
    return out


def conserved_fields(pressure, temperature, dewpoint):
    """The mixing-conserved per-level fields (theta, mixing ratio) — compute
    once and share when mixing several depths of the same columns (the
    pipeline mixes 100 and 50 hPa layers of identical inputs)."""
    return {'theta': thermo.potential_temperature(pressure, temperature),
            'mixing_ratio': thermo.saturation_mixing_ratio(pressure,
                                                           dewpoint)}


def mixed_parcel(pressure, temperature, dewpoint, depth=100.0,
                 conserved=None, neighbors=None):
    """Fully mix a surface-based layer: conserve theta and mixing ratio,
    return the parcel's pressure/temperature/dewpoint
    (reference: modules/parcel_functions.py:229-289).
    ``conserved``: optional precomputed :func:`conserved_fields`.
    ``neighbors``: optional precomputed :func:`bridge_neighbors` for the
    jointly-valid (finite p, t, td) level mask.

    Both conserved fields derive from (p, t, td), so mixing runs in the
    shared whole-level-validity mode — one scan pair, reusable across
    depths."""
    pressure = jnp.asarray(pressure)
    # First VALID pressure, not slot 0: columns may carry a leading-NaN
    # prefix (this framework's first-valid-index contract; the reference
    # anchors at isel(0), :250, because its inputs are pre-compacted).
    # Pressures sort decreasing, so the first valid level is nanmax —
    # consistent with mixed_layer's ``bottom`` and mix_layer's keep mask.
    parcel_start_pressure = nanmax(pressure)

    valid = (notnan(pressure) & notnan(temperature) &
             notnan(dewpoint))
    if conserved is None:
        conserved = conserved_fields(pressure, temperature, dewpoint)

    mixed = mixed_layer({'pressure': pressure, **conserved}, depth=depth,
                        valid=valid, neighbors=neighbors)

    temp = mixed['theta'] * thermo.exner_function(parcel_start_pressure)
    vap = thermo.vapor_pressure(parcel_start_pressure, mixed['mixing_ratio'])
    dew = thermo.dewpoint(vap)
    return {'pressure': parcel_start_pressure, 'temperature': temp,
            'dewpoint': dew}


def most_unstable_parcel(pressure, temperature, dewpoint, depth=300.0):
    """The max-theta-e parcel in the surface-based layer of given depth;
    ties take the first (lowest) level
    (reference: modules/parcel_functions.py:102-135).

    Selection is by LEVEL INDEX (first level achieving the max), not by
    pressure-value equality: with duplicate pressure levels a value match
    would blend temperature/dewpoint across the duplicates into a parcel
    state that exists at no level.  (The reference refuses such columns
    outright — its uniqueness assert at :131 — which a jitted program
    cannot do; picking the first matching level is the documented tie
    rule extended to duplicates.)"""
    layer = get_layer({'pressure': pressure, 'temperature': temperature,
                       'dewpoint': dewpoint}, depth=depth, interpolate=False)
    eq = thermo.equivalent_potential_temperature(
        layer['pressure'], layer['temperature'], layer['dewpoint'])
    max_eq = nanmax(eq)
    k = jnp.argmax(eq == max_eq[..., None], axis=-1)
    sel = ((jnp.arange(eq.shape[-1]) == k[..., None]) &
           notnan(max_eq)[..., None])
    return {k_: nanmax(v, where=sel) for k_, v in layer.items()}


def from_most_unstable_parcel(pressure, temperature, dewpoint, depth=300.0):
    """Subset columns to levels at/above the most unstable parcel
    (reference: modules/parcel_functions.py:1517-1555).

    Returns (fields dict with (…, L) NaN-masked columns, parcel dict).
    The reference left-shifts the subset so the parcel sits at index 0; here
    the sub-parcel prefix simply stays NaN — every downstream op (splice,
    crossing set, LFC/EL first-level rules, integration) is first-valid-
    index aware, and skipping the per-column shift network saves ~40
    full-field passes per solve.
    """
    parcel = most_unstable_parcel(pressure, temperature, dewpoint,
                                  depth=depth)
    keep = pressure <= parcel['pressure'][..., None]
    return {
        'pressure': jnp.where(keep, pressure, jnp.nan),
        'temperature': jnp.where(keep, temperature, jnp.nan),
        'dewpoint': jnp.where(keep, dewpoint, jnp.nan),
    }, parcel


def mix_layer(pressure, temperature, dewpoint, depth=100.0, conserved=None,
              neighbors=None, grow=True):
    """Replace the lowest ``depth`` hPa with the fully-mixed parcel as the
    new bottom level (reference: modules/parcel_functions.py:1604-1649).

    Returns (fields dict — a NaN prefix over the mixed-away levels, then
    the parcel, then the kept levels — and the mixed parcel dict).  The
    reference compacts the kept levels down to index 0; here the parcel is
    spliced in place via the leading-NaN-aware ``insert_level``
    (one splice instead of a per-column shift network).
    ``conserved``/``neighbors``: optional precomputed
    :func:`conserved_fields` / :func:`bridge_neighbors` (share both when
    mixing several depths of the same columns).

    ``grow``: with True (default) the splice produces (…, L+1) columns via
    ``insert_level``.  With False the parcel is written into the last
    masked-prefix slot of the ORIGINAL (…, L) columns instead — always a
    free slot, since the bottom level is by construction within ``depth``
    hPa of itself and therefore mixed away — skipping the splice's shift
    network entirely (the fused pipelines' hot path; same physical
    profile, one level of NaN prefix less).
    """
    pressure = jnp.asarray(pressure)
    mp = mixed_parcel(pressure, temperature, dewpoint, depth=depth,
                      conserved=conserved, neighbors=neighbors)

    keep = pressure < (nanmax(pressure) - depth)[..., None]
    masked = {
        'pressure': jnp.where(keep, pressure, jnp.nan),
        'temperature': jnp.where(keep, jnp.broadcast_to(temperature,
                                                        pressure.shape),
                                 jnp.nan),
        'dewpoint': jnp.where(keep, jnp.broadcast_to(dewpoint,
                                                     pressure.shape),
                              jnp.nan),
    }
    if grow:
        return insert_level(masked, mp), mp
    # Slot write: the parcel goes right below the first kept level.  Any
    # kept level implies first_kept >= 1 (the bottom valid level is always
    # masked); with nothing kept (the whole column mixed away, or all-NaN)
    # slot 0 matches insert_level's "insert above a NaN flood" placement.
    kept = notnan(masked['pressure'])
    first_kept = jnp.argmax(kept, axis=-1)
    slot = jnp.where(kept.any(-1), first_kept - 1, 0)[..., None]
    j = jax.lax.broadcasted_iota(jnp.int32, pressure.shape,
                                 pressure.ndim - 1)
    at = j == slot
    out = {k: jnp.where(at, jnp.asarray(mp[k])[..., None], masked[k])
           for k in masked}
    return out, mp


def most_unstable_cape_cin(pressure, temperature, dewpoint, depth=300.0,
                           **kwargs):
    """CAPE/CIN for the most-unstable parcel in the lowest ``depth`` hPa
    (reference: modules/parcel_functions.py:1557-1602).

    Returns (cape_cin dict, profile dict, parcel dict).
    """
    fields, parcel = from_most_unstable_parcel(pressure, temperature,
                                               dewpoint, depth=depth)
    res, profile = cape_cin(fields['pressure'], fields['temperature'],
                            fields['dewpoint'],
                            parcel_temperature=parcel['temperature'],
                            parcel_pressure=parcel['pressure'],
                            parcel_dewpoint=parcel['dewpoint'], **kwargs)
    return res, profile, parcel


def mixed_layer_cape_cin(pressure, temperature, dewpoint, depth=100.0,
                         conserved=None, neighbors=None, **kwargs):
    """CAPE/CIN for the fully-mixed lowest ``depth`` hPa parcel
    (reference: modules/parcel_functions.py:1651-1697).

    Returns (cape_cin dict, profile dict, parcel dict).
    """
    fields, mp = mix_layer(pressure, temperature, dewpoint, depth=depth,
                           conserved=conserved, neighbors=neighbors)
    res, profile = cape_cin(fields['pressure'], fields['temperature'],
                            fields['dewpoint'],
                            parcel_temperature=mp['temperature'],
                            parcel_pressure=mp['pressure'],
                            parcel_dewpoint=mp['dewpoint'], **kwargs)
    return res, profile, mp
