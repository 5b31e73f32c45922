"""Point thermodynamics, MetPy-1.4.1-faithful, as pure jax.numpy functions.

The reference library calls ``metpy.calc`` per element for these quantities
(reference: modules/parcel_functions.py:8-16 and call sites passim).  MetPy is
a CPU/pint library and cannot run on device, so this module re-derives every
formula the reference exercises, with MetPy 1.4.1 semantics (the golden-test
truths in the reference's modules/unit_tests.py depend on them — notably the
*approximate* ``mixing_ratio_from_relative_humidity``, which changed in later
MetPy versions; see the reference's environment_changes_eval.ipynb).

All functions are elementwise, dtype-polymorphic (fp32 in production,
fp64 under ``jax_enable_x64`` for validation), NaN-transparent, and safe
under jit/vmap.
Units follow the reference convention: pressure in hPa, temperature in K,
mixing ratio in kg/kg.
"""

import jax.numpy as jnp

from . import constants as c


def saturation_vapor_pressure(temperature):
    """Bolton (1980) saturation vapour pressure [hPa] of temperature [K]."""
    t = temperature
    return c.sat_pressure_0c * jnp.exp(17.67 * (t - 273.15) / (t - 29.65))


def dewpoint(vapor_pressure_hpa):
    """Dewpoint [K] from water vapour partial pressure [hPa] (Bolton inverse)."""
    val = jnp.log(vapor_pressure_hpa / c.sat_pressure_0c)
    return c.zero_degc + 243.5 * val / (17.67 - val)


def vapor_pressure(pressure, mixing_ratio):
    """Water vapour partial pressure [hPa] from total pressure and w [kg/kg]."""
    return pressure * mixing_ratio / (c.epsilon + mixing_ratio)


def mixing_ratio_from_partial_pressure(partial_pressure, total_pressure):
    """w [kg/kg] from a partial pressure and total pressure [hPa]."""
    return c.epsilon * partial_pressure / (total_pressure - partial_pressure)


def saturation_mixing_ratio(pressure, temperature):
    """Saturation mixing ratio w_s [kg/kg] at pressure [hPa], temperature [K]."""
    return mixing_ratio_from_partial_pressure(
        saturation_vapor_pressure(temperature), pressure)


def relative_humidity_from_dewpoint(temperature, dewpoint_temperature):
    """RH (0-1) from temperature and dewpoint [K]."""
    return (saturation_vapor_pressure(dewpoint_temperature) /
            saturation_vapor_pressure(temperature))


def mixing_ratio_from_relative_humidity(pressure, temperature, relative_humidity):
    """MetPy-1.4.1 approximate form: w = RH * w_s (NOT the exact inversion).

    The reference's accuracy anchor is MetPy 1.4.1; later MetPy versions use the
    exact formula, which shifts CAPE/CIN by up to hundreds of J/kg (reference:
    environment_changes_eval.ipynb cell 13-14).
    """
    return relative_humidity * saturation_mixing_ratio(pressure, temperature)


def mixing_ratio(temperature, dewpoint_temperature, pressure):
    """RH-route mixing ratio — mirrors the reference's own helper
    (reference: modules/parcel_functions.py:684-710).

    Algebraically fused: rh * w_s = [svp(td)/svp(t)] * [eps*svp(t)/(p-svp(t))]
    = eps*svp(td)/(p-svp(t)) — the numerator svp(t) cancels exactly, saving
    one vector divide and one multiply per call (same MetPy-1.4.1 approximate
    semantics, pure reassociation)."""
    return (c.epsilon * saturation_vapor_pressure(dewpoint_temperature) /
            (pressure - saturation_vapor_pressure(temperature)))


def exner_function(pressure):
    """Exner function (p / 1000 hPa)^kappa."""
    return (pressure / c.P0) ** c.kappa


def potential_temperature(pressure, temperature):
    """theta [K] = T / Exner(p)."""
    return temperature / exner_function(pressure)


def virtual_temperature(temperature, mixing_ratio, epsilon=c.virtual_temperature_epsilon):
    """Doswell & Rasmussen (1994) virtual temperature, default epsilon 0.608
    (reference: modules/parcel_functions.py:782-804)."""
    return temperature * (1.0 + epsilon * mixing_ratio)


def equivalent_potential_temperature(pressure, temperature, dewpoint_temperature):
    """Bolton (1980) theta-e [K] — MetPy 1.4.1 formula.

    Used by the most-unstable-parcel search
    (reference: modules/parcel_functions.py:123-126).
    """
    t = temperature
    td = dewpoint_temperature
    p = pressure
    e = saturation_vapor_pressure(td)
    r = mixing_ratio_from_partial_pressure(e, p)
    t_l = 56.0 + 1.0 / (1.0 / (td - 56.0) + jnp.log(t / td) / 800.0)
    th_l = t * (c.P0 / (p - e)) ** c.kappa * (t / t_l) ** (0.28 * r)
    return th_l * jnp.exp(r * (1.0 + 0.448 * r) * (3036.0 / t_l - 1.78))


def mixing_ratio_from_specific_humidity(specific_humidity):
    """w = q / (1 - q)."""
    return specific_humidity / (1.0 - specific_humidity)


def specific_humidity_from_mixing_ratio(mixing_ratio):
    """q = w / (1 + w)."""
    return mixing_ratio / (1.0 + mixing_ratio)


def specific_humidity_from_dewpoint(pressure, dewpoint_temperature):
    """q from dewpoint via saturation mixing ratio at the dewpoint."""
    w = saturation_mixing_ratio(pressure, dewpoint_temperature)
    return specific_humidity_from_mixing_ratio(w)


def relative_humidity_from_specific_humidity(pressure, temperature, specific_humidity):
    """MetPy-1.4.1 approximate RH = w(q) / w_s(p, T)."""
    return (mixing_ratio_from_specific_humidity(specific_humidity) /
            saturation_mixing_ratio(pressure, temperature))


def dewpoint_from_relative_humidity(temperature, relative_humidity):
    """Dewpoint [K] from RH: invert Bolton at e = RH * e_s(T)."""
    return dewpoint(relative_humidity * saturation_vapor_pressure(temperature))


def dewpoint_from_specific_humidity(pressure, temperature, specific_humidity):
    """MetPy-1.4.1 chain used by the reference pipelines
    (reference: modules/parcel_functions.py:1888-1894, 1968-1974)."""
    rh = relative_humidity_from_specific_humidity(pressure, temperature,
                                                  specific_humidity)
    return dewpoint_from_relative_humidity(temperature, rh)


def dry_lapse(pressure, parcel_temperature, parcel_pressure):
    """Poisson dry adiabat: T * (p / p0)^kappa
    (reference: modules/parcel_functions.py:291-316)."""
    return parcel_temperature * (pressure / parcel_pressure) ** c.kappa


def moist_lapse_rate(pressure, temperature):
    """Pseudoadiabatic dT/dp [K/hPa] (Bakhshaii & Stull form, as used by MetPy
    moist_lapse and reference: modules/moist_lapse_analytic.py:12-32)."""
    rs = saturation_mixing_ratio(pressure, temperature)
    frac = ((c.Rd * temperature + c.Lv * rs) /
            (c.Cp_d + (c.Lv * c.Lv * rs * c.epsilon / (c.Rd * temperature ** 2))))
    return frac / pressure


def wet_bulb_temperature_fast(temperature, dewpoint_temperature):
    """Knox et al. (2017) one-third rule
    (reference: modules/parcel_functions.py:364-387)."""
    return temperature - (1.0 / 3.0) * (temperature - dewpoint_temperature)
