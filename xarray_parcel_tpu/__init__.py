"""xarray_parcel_tpu — accelerator-native parcel-theory framework.

A from-scratch JAX/XLA rebuild of the capability surface of
traupach/xarray_parcel: parcel lifting (dry/moist adiabats), LCL/LFC/EL,
CAPE/CIN (surface-based, mixed-layer, most-unstable) with virtual-temperature
correction, lifted index, DCI, wet-bulb temperature, freezing/melting levels,
wind shear, SHIP and storm proxies — vectorised over every column of a grid
and sharded over a device mesh.

Data model: plain jax arrays, batch dims leading, the vertical level axis
last; NaN marks missing data; pressure in hPa, temperature in K, mixing ratio
in kg/kg (the reference's implicit unit convention).
"""

from . import constants, thermo, ops
from . import adiabat, lcl, profile, parcels, cape, diagnostics, pipeline
from . import api, fieldset, fused, xarray_api

__version__ = '0.1.0'
