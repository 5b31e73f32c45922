"""Output metadata: the reference's xarray-attrs observability layer.

The reference attaches ``long_name``/``units``/``description`` attrs to every
output variable (e.g. reference: modules/parcel_functions.py:1367-1368,
2303-2304) — its de-facto observability surface.  jax arrays carry no attrs,
so metadata lives in a canonical registry keyed by variable name; ``annotate``
wraps a result dict in a ``FieldSet`` exposing ``.attrs``.  A FieldSet is a
registered pytree that traverses like a dict (attrs ride along as aux data),
so annotated outputs flow through jit/sharding/sync unchanged.
"""

import jax
import re


class FieldSet(dict):
    """A dict of named arrays with attribute access and per-variable attrs.

    ``_attr_overrides``: optional {name: description} texts that take
    precedence over the registry (the reference's ``description=``
    parameters on lifted_index/DCI).
    """

    def __init__(self, *args, _attr_overrides=None, **kwargs):
        super().__init__(*args, **kwargs)
        object.__setattr__(self, '_overrides', dict(_attr_overrides or {}))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    @property
    def attrs(self):
        out = {}
        for k in self:
            a = attrs_for(k)
            if k in getattr(self, '_overrides', {}):
                a['description'] = self._overrides[k]
            out[k] = a
        return out


def _fieldset_flatten_with_keys(fs):
    keys = sorted(fs)
    children = [(jax.tree_util.DictKey(k), fs[k]) for k in keys]
    return children, (tuple(keys), tuple(sorted(fs._overrides.items())))


def _fieldset_unflatten(aux, children):
    keys, overrides = aux
    return FieldSet(zip(keys, children), _attr_overrides=dict(overrides))


# A FieldSet must traverse like the dict it is — NOT sit as a pytree leaf —
# so API outputs can be fed straight back into jax.jit / shard_batch /
# utils.sync (a leaf FieldSet would make jit raise and make sync silently
# skip waiting for the device).
jax.tree_util.register_pytree_with_keys(
    FieldSet, _fieldset_flatten_with_keys, _fieldset_unflatten)


_BASE_ATTRS = {
    'cape': {'long_name': 'Convective available potential energy',
             'units': 'J kg$^{-1}$'},
    'cin': {'long_name': 'Convective inhibition', 'units': 'J kg$^{-1}$'},
    'lifted_index': {'long_name': 'Lifted index', 'units': 'K'},
    'dci': {'long_name': 'Deep convective index', 'units': 'C'},
    'mixing_ratio': {'long_name': 'Mixing ratio', 'units': 'kg kg$^{-1}$'},
    'lcl_pressure': {'long_name': 'Lifting condensation level pressure',
                     'units': 'hPa'},
    'lcl_temperature': {'long_name': 'Lifting condensation level temperature',
                        'units': 'K'},
    'lcl_virtual_temperature': {
        'long_name': 'Lifting condensation level virtual temperature',
        'units': 'K'},
    'lfc_pressure': {'long_name': 'Level of free convection pressure',
                     'units': 'hPa'},
    'lfc_temperature': {'long_name': 'Level of free convection temperature',
                        'units': 'K'},
    'el_pressure': {'long_name': 'Equilibrium level pressure', 'units': 'hPa'},
    'el_temperature': {'long_name': 'Equilibrium level temperature',
                       'units': 'K'},
    'pressure': {'long_name': 'Pressure', 'units': 'hPa'},
    'temperature': {'long_name': 'Temperature', 'units': 'K'},
    'virtual_temperature': {'long_name': 'Virtual temperature', 'units': 'K'},
    'dewpoint': {'long_name': 'Dewpoint', 'units': 'K'},
    'environment_temperature': {'long_name': 'Environment temperature',
                                'units': 'K'},
    'environment_virtual_temperature': {
        'long_name': 'Environment virtual temperature', 'units': 'K'},
    'environment_dewpoint': {'long_name': 'Environment dewpoint',
                             'units': 'K'},
    'lapse_rate_700_500': {'long_name': 'Lapse rate',
                           'description': '700-500 hPa lapse rate',
                           'units': 'K km$^{-1}$'},
    'temp_500': {'long_name': 'Isobar temperature',
                 'description': 'Temperature at 500 hPa.', 'units': 'K'},
    'freezing_level': {
        'long_name': 'Freezing-level height',
        'description': 'Height of zero degree dry-bulb temperature isotherm.',
        'units': 'm'},
    'melting_level': {
        'long_name': 'Melting-level height',
        'description': 'Height of zero degree wet-bulb temperature isotherm.',
        'units': 'm'},
    'wet_bulb_temperature': {'long_name': 'Wet bulb temperature',
                             'units': 'K'},
    'shear_u': {'long_name': 'Surface to 6000 m wind shear, U component.',
                'units': 'm s$^{-1}$'},
    'shear_v': {'long_name': 'Surface to 6000 m wind shear, V component.',
                'units': 'm s$^{-1}$'},
    'shear_magnitude': {'long_name': 'Surface to 6000 m bulk wind shear.',
                        'units': 'm s$^{-1}$'},
    'positive_shear': {'long_name': 'True if 6000 m wind > surface wind.'},
    'ship': {'long_name': 'Significant hail parameter (SHIP)',
             'units': 'J kg$^{-2}$ g K$^2$ km$^{-1}$ m s$^{-1}$'},
}

_PREFIX_DESCRIPTIONS = {
    'mu': 'most-unstable parcel in lowest 250 hPa',
    'mixed_100': 'fully-mixed lowest 100 hPa parcel',
    'mixed_50': 'fully-mixed lowest 50 hPa parcel',
}

_PROXY_STUDIES = {
    'proxy_Craven2004': 'Craven 2004', 'proxy_Kunz2007': 'Kunz 2007',
    'proxy_Trapp2007': 'Trapp 2007', 'proxy_Marsh2009': 'Marsh 2009',
    'proxy_Allen2011': 'Allen 2011', 'proxy_Allen2014': 'Allen 2014',
    'proxy_Eccel2012': 'Eccel 2012', 'proxy_Mohr2013': 'Mohr 2013',
    'proxy_SHIP_0.1': 'SHIP > 0.1',
}


def attrs_for(name):
    """Canonical attrs for a variable name, resolving prefixes like
    ``mu_cape`` or ``mixed_100_lifted_index``."""
    if name in _BASE_ATTRS:
        return dict(_BASE_ATTRS[name])
    if name in _PROXY_STUDIES:
        return {'long_name': 'Proxy ' + _PROXY_STUDIES[name]}
    # Parameterized diagnostics: isobar_temperature/lapse_rate output names
    # track the pressures actually used (temp_850, lapse_rate_850_700 …) —
    # annotate from the base entries with the real pressures substituted.
    m = re.fullmatch(r'temp_([0-9][0-9.]*)', name)
    if m:
        base = dict(_BASE_ATTRS['temp_500'])
        base['description'] = f'Temperature at {m.group(1)} hPa.'
        return base
    m = re.fullmatch(r'lapse_rate_([0-9][0-9.]*)_([0-9][0-9.]*)', name)
    if m:
        base = dict(_BASE_ATTRS['lapse_rate_700_500'])
        base['description'] = f'{m.group(1)}-{m.group(2)} hPa lapse rate'
        return base
    for prefix, desc in _PREFIX_DESCRIPTIONS.items():
        tag = prefix + '_'
        if name.startswith(tag) and name[len(tag):] in _BASE_ATTRS:
            base = dict(_BASE_ATTRS[name[len(tag):]])
            base['description'] = (
                f'{base.get("long_name", name)} for {desc}.')
            return base
    # Unknown prefixes still keep the base variable's attrs: the reference
    # renames AFTER attaching long_name/units, so ``prefix='sb'`` outputs
    # stay annotated (reference: modules/parcel_functions.py:1749-1755).
    parts = name.split('_')
    for i in range(1, len(parts)):
        suffix = '_'.join(parts[i:])
        if suffix in _BASE_ATTRS:
            return dict(_BASE_ATTRS[suffix])
    return {}


def annotate(result, descriptions=None):
    """Wrap a result dict in a FieldSet (attrs resolve lazily by name);
    ``descriptions``: optional {name: text} overrides."""
    return FieldSet(result, _attr_overrides=descriptions)
