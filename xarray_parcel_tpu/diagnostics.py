"""Scalar convection diagnostics.

Vectorised equivalents of reference: modules/parcel_functions.py:1722-1870,
2102-2306 and :364-445 — lifted index, deep convective index, lapse rate,
isobar temperature, freezing/melting level heights, wet-bulb temperature
(exact and fast), bulk wind shear and the significant hail parameter.

The exact wet-bulb calculation is the showpiece redesign: the reference warns
that its per-level Python loop "performs badly when dask is used" and loads
everything into memory (reference: modules/parcel_functions.py:404-410); here
every level of every column is treated as an independent parcel, so the whole
field is one fused LCL + pointwise moist-lapse evaluation.
"""

import jax.numpy as jnp

from . import adiabat, thermo
from .lcl import lcl
from .ops import find_intersections, interp_many, log_interp, nanmin, notnan


def lifted_index(profile):
    """Galway (1956) lifted index: environment minus parcel temperature at
    500 hPa (reference: modules/parcel_functions.py:1722-1756)."""
    env, parcel = interp_many(
        (profile['environment_temperature'], profile['temperature']),
        profile['pressure'], 500.0, log=True)
    return {'lifted_index': env - parcel}


def deep_convective_index(pressure, temperature, dewpoint, lifted_index,
                          anchors_850=None):
    """Kunz (2009) DCI: T850C + Td850C - LI
    (reference: modules/parcel_functions.py:1830-1870).

    ``anchors_850``: optional precomputed ``(t850, td850)`` — the pipelines
    compute them once and share across all three parcel variants' DCIs
    (the LI is the only per-parcel term)."""
    if anchors_850 is None:
        anchors_850 = interp_many((temperature, dewpoint), pressure, 850.0,
                                  log=True)
    t850, td850 = anchors_850
    return {'dci': (t850 - 273.15) + (td850 - 273.15) - lifted_index}


def lapse_rate(pressure, temperature, height, from_pressure=700.0,
               to_pressure=500.0, with_isobars=False):
    """Environmental lapse rate [K/km] between two pressure levels
    (reference: modules/parcel_functions.py:2102-2135).

    ``with_isobars``: also return the interpolated (t_from, t_to) — the
    pipelines reuse t_to as ``temp_500`` instead of re-interpolating."""
    t_from, h_from = interp_many((temperature, height), pressure,
                                 from_pressure, log=True)
    t_to, h_to = interp_many((temperature, height), pressure, to_pressure,
                             log=True)
    rate = (t_to - t_from) / ((h_to - h_from) / 1000.0)
    return (rate, t_from, t_to) if with_isobars else rate


def isobar_temperature(pressure, temperature, isobar):
    """Temperature at a given pressure level
    (reference: modules/parcel_functions.py:2193-2214)."""
    return log_interp(temperature, pressure, isobar)


def freezing_level_height(temperature, height):
    """Height [m] of the lowest 0 C crossing of the (dry-bulb) temperature
    (reference: modules/parcel_functions.py:2137-2160)."""
    zeros = jnp.broadcast_to(jnp.asarray(273.15, temperature.dtype),
                             temperature.shape)
    ints = find_intersections(height, temperature, zeros)
    return nanmin(ints['all_x'])


def wet_bulb_temperature(pressure, temperature, dewpoint, tables=None,
                         moist_lapse=None):
    """Exact wet-bulb temperature by Normand's rule: lift each point dry to
    its LCL, bring it moist-adiabatically back down to its own pressure
    (reference: modules/parcel_functions.py:389-445, here fully vectorised —
    one elementwise LCL solve + one pointwise moist-lapse per point).

    Default backend is direct RK4 integration (the LCL sits a short
    |dln p| above each point, so the integration is exact, elementwise and
    gather-free — cheaper than the pointwise table lookup the
    reference uses; pass ``moist_lapse=adiabat.moist_lapse`` for the
    table-faithful path).  The table envelope's NaN contract is preserved
    either way: out-of-model states give NaN, never extrapolation."""
    ml = moist_lapse or adiabat.moist_lapse_integrate
    lcls = lcl(pressure, temperature, dewpoint)
    wb = ml(pressure, lcls['lcl_temperature'], lcls['lcl_pressure'],
            tables=tables, pointwise=True)
    # The integrate backend has no table envelope; re-impose it so validity
    # semantics match the reference's table consumer.
    fidx = adiabat.curve_index_integrate(lcls['lcl_pressure'],
                                         lcls['lcl_temperature'])
    ok = (notnan(fidx) & (pressure >= adiabat.P_BOT) &
          (pressure <= adiabat.P_TOP))
    return jnp.where(ok, wb, jnp.nan)


def melting_level_height(pressure, temperature, dewpoint, height, fast=True,
                         tables=None, moist_lapse=None):
    """Height of the 0 C wet-bulb isotherm; fast variant uses the Knox 1/3
    rule (reference: modules/parcel_functions.py:2162-2191).

    Returns (melting level height, wet-bulb temperature field).
    """
    if fast:
        wb = thermo.wet_bulb_temperature_fast(temperature, dewpoint)
    else:
        wb = wet_bulb_temperature(pressure, temperature, dewpoint,
                                  tables=tables, moist_lapse=moist_lapse)
    return freezing_level_height(wb, height), wb


def wind_shear(surface_wind_u, surface_wind_v, wind_u, wind_v, height,
               shear_height=6000.0):
    """Bulk wind shear between the surface wind and the wind interpolated at
    ``shear_height`` (reference: modules/parcel_functions.py:2216-2259).

    Returns dict with shear_u, shear_v, shear_magnitude, positive_shear.
    """
    high_u, high_v = interp_many((wind_u, wind_v), height, shear_height)
    shear_u = high_u - surface_wind_u
    shear_v = high_v - surface_wind_v
    high_mag = jnp.sqrt(high_u ** 2 + high_v ** 2)
    surf_mag = jnp.sqrt(surface_wind_u ** 2 + surface_wind_v ** 2)
    return {
        'shear_u': shear_u,
        'shear_v': shear_v,
        'shear_magnitude': jnp.sqrt(shear_u ** 2 + shear_v ** 2),
        'positive_shear': high_mag > surf_mag,
    }


def significant_hail_parameter(mucape, mixing_ratio, lapse, temp_500, shear,
                               flh):
    """SPC significant hail parameter with its published validity thresholds
    and correction factors (reference: modules/parcel_functions.py:2261-2306).
    """
    mixing_ratio = mixing_ratio * 1e3          # kg/kg -> g/kg
    lapse = -lapse                             # positive lapse rates
    temp_500 = temp_500 - 273.15               # K -> C

    shear = jnp.where((shear >= 7.0) & (shear <= 27.0), shear, jnp.nan)
    mixing_ratio = jnp.where((mixing_ratio >= 11.0) & (mixing_ratio <= 13.6),
                             mixing_ratio, jnp.nan)
    temp_500 = jnp.where(temp_500 <= -5.5, temp_500, -5.5)

    ship = mucape * mixing_ratio * lapse * -temp_500 * shear / 42000000.0

    ship = jnp.where(mucape >= 1300.0, ship, ship * (mucape / 1300.0))
    ship = jnp.where(lapse >= 5.8, ship, ship * (lapse / 5.8))
    ship = jnp.where(flh >= 2400.0, ship, ship * (flh / 2400.0))
    return ship
