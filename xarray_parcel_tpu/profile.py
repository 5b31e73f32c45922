"""Lifted-parcel temperature profiles (dry below LCL, moist above).

Vectorised equivalents of the reference's profile builders
(reference: modules/parcel_functions.py:712-931): fixed-shape columns with
the LCL spliced in as an extra level via the static-shape ``insert_level``
gather, virtual-temperature track computed alongside.

All functions take/return plain arrays (batch dims leading, level axis last)
in dicts keyed like the reference's Dataset variables.
"""

import jax.numpy as jnp

from . import adiabat, thermo
from .lcl import lcl
from .ops import insert_level, interp_many, notnan


def parcel_profile(pressure, parcel_pressure, parcel_temperature,
                   parcel_dewpoint, tables=None, moist_lapse=None):
    """Temperature (+virtual temperature) of a parcel lifted to ``pressure``.

    ``pressure``: (…, L); parcel state: (…).  Returns dict with 'pressure',
    'temperature', 'virtual_temperature', 'lcl_pressure', 'lcl_temperature',
    'lcl_virtual_temperature' (reference: modules/parcel_functions.py:712-780).

    ``moist_lapse`` selects the lifting backend (defaults to the table
    consumer ``adiabat.moist_lapse``; pass ``adiabat.moist_lapse_integrate``
    for the exact-ODE oracle, mirroring the reference's monkeypatch testing
    strategy).
    """
    ml = moist_lapse or adiabat.moist_lapse
    pressure = jnp.asarray(pressure)
    parcel_pressure = jnp.asarray(parcel_pressure)
    parcel_temperature = jnp.asarray(parcel_temperature)
    parcel_dewpoint = jnp.asarray(parcel_dewpoint)
    # A shared level vector with batched parcels is legal (as in
    # cape.cape_cin): carry the full (batch, L) pressure so every track and
    # the downstream LCL splice share one shape.
    batch = jnp.broadcast_shapes(parcel_pressure.shape,
                                 parcel_temperature.shape,
                                 parcel_dewpoint.shape,
                                 pressure.shape[:-1])
    pressure = jnp.broadcast_to(pressure, batch + pressure.shape[-1:])

    out = {'pressure': pressure}
    out.update(lcl(parcel_pressure, parcel_temperature, parcel_dewpoint))
    lcl_p = out['lcl_pressure']

    # NaN levels (pads / masked sub-parcel prefixes / poisoned data) must
    # yield NaN outputs but never ENTER the arithmetic: exp/log/power/multiply
    # leak NaN into reverse-mode cotangents even when masked downstream (the
    # where-NaN gradient trap), so compute on safe finite dummies and apply
    # the NaN pattern at the end.
    validp = notnan(pressure)
    safe_p = jnp.where(validp, pressure, 500.0)

    below_lcl = thermo.dry_lapse(safe_p, parcel_temperature[..., None],
                                 parcel_pressure[..., None])
    above_lcl = ml(safe_p, out['lcl_temperature'], lcl_p, tables=tables,
                   pointwise=False)
    above_lcl = jnp.where(validp, above_lcl, jnp.nan)

    lcl_pb = lcl_p[..., None]
    temp = jnp.where(pressure >= lcl_pb, below_lcl, above_lcl)
    temp = jnp.where(validp, temp, jnp.nan)
    out['temperature'] = temp

    # Mixing ratio: parcel's (constant) below the LCL, saturated above.
    parcel_w = thermo.mixing_ratio(parcel_temperature, parcel_dewpoint,
                                   parcel_pressure)
    validt = notnan(temp)
    safe_t = jnp.where(validt, temp, 273.15)
    sat_w = thermo.saturation_mixing_ratio(safe_p, safe_t)

    w = jnp.where(pressure <= lcl_pb, sat_w, parcel_w[..., None])
    vt = thermo.virtual_temperature(safe_t, w)
    out['virtual_temperature'] = jnp.where(validt, vt, jnp.nan)
    return out


def add_lcl_to_profile(profile, environment=None, interpolator='log'):
    """Splice the LCL level into a profile (and optionally the environment).

    Mirrors the reference (reference: modules/parcel_functions.py:858-931):
    the environment temperature/dewpoint are interpolated at the LCL pressure
    (log-p by default; MetPy uses linear), the environment virtual
    temperature at the LCL is *recomputed* from the interpolated T/Td, and
    both profile and environment gain one level.
    """
    assert interpolator in ('linear', 'log')

    level = {'pressure': profile['lcl_pressure'],
             'temperature': profile['lcl_temperature'],
             'virtual_temperature': profile['lcl_virtual_temperature']}
    out = insert_level(
        {k: profile[k] for k in ('pressure', 'temperature',
                                 'virtual_temperature')}, level)
    for k in ('lcl_pressure', 'lcl_temperature', 'lcl_virtual_temperature'):
        out[k] = profile[k]

    if environment is not None:
        env_p = environment['pressure']
        # virtual_temperature at the LCL is RECOMPUTED from interpolated
        # T/Td below (reference :911-920) — interpolating it too would be
        # two wasted masked reductions per solve.
        skip = ('pressure', 'virtual_temperature') \
            if 'virtual_temperature' in environment else ('pressure',)
        interp_level = interp_many(
            {k: v for k, v in environment.items() if k not in skip},
            env_p, level['pressure'], log=interpolator == 'log')
        interp_level['pressure'] = level['pressure']

        if 'virtual_temperature' in environment:
            mix = thermo.mixing_ratio(interp_level['temperature'],
                                      interp_level['dewpoint'],
                                      interp_level['pressure'])
            interp_level['virtual_temperature'] = thermo.virtual_temperature(
                interp_level['temperature'], mix)

        new_env = insert_level(environment, interp_level)
        for k in environment:
            if k != 'pressure':
                out['environment_' + k] = new_env[k]
    return out


def parcel_profile_with_lcl(pressure, temperature, dewpoint, parcel_pressure,
                            parcel_temperature, parcel_dewpoint,
                            lcl_interp='log', tables=None, moist_lapse=None):
    """Parcel profile including the LCL level, plus the environment
    (virtual) temperature track spliced at the LCL
    (reference: modules/parcel_functions.py:806-856).

    Output columns have L+1 levels.
    """
    profile = parcel_profile(pressure, parcel_pressure, parcel_temperature,
                             parcel_dewpoint, tables=tables,
                             moist_lapse=moist_lapse)

    # Safe dummies at NaN levels; NaN pattern re-imposed after (see
    # parcel_profile — the where-NaN gradient trap).
    valid = (notnan(temperature) & notnan(dewpoint) &
             notnan(pressure))
    safe_t = jnp.where(valid, temperature, 273.15)
    safe_td = jnp.where(valid, dewpoint, 263.15)
    safe_p = jnp.where(valid, pressure, 500.0)
    mix = thermo.mixing_ratio(safe_t, safe_td, safe_p)
    env_vt = jnp.where(valid, thermo.virtual_temperature(safe_t, mix),
                       jnp.nan)
    environment = {
        'temperature': jnp.broadcast_to(temperature, profile['pressure'].shape),
        'virtual_temperature': jnp.broadcast_to(env_vt,
                                                profile['pressure'].shape),
        'dewpoint': jnp.broadcast_to(dewpoint, profile['pressure'].shape),
        'pressure': profile['pressure'],
    }
    return add_lcl_to_profile(profile, environment=environment,
                              interpolator=lcl_interp)
