"""Canonical dimension / coordinate / feature naming standard.

Every dataset entering the framework is normalized to:
  * dims ordered ``(space, south_north, west_east, time, level, height)``
    (only the dims present are kept, in that relative order)
  * coordinates named ``latitude``, ``longitude``, ``time``, ``level``
  * lowercase feature names, with height/pressure suffixes like
    ``u_100m`` / ``temperature_850pa``.

Mirrors the naming standard of the reference implementation
(reference: sup3r/preprocessing/names.py:7-197) so configs and trained
pipelines are interchangeable. The port's own copy of
``sup3r_tpu/names.py``.
"""

import re


class Dimension(str):
    """Singleton-style names for canonical dims.

    A plain ``str`` subclass namespace (not an Enum) — values compare
    equal to their strings and are usable as dict keys directly.
    """

    FLATTENED_SPATIAL = 'space'
    SOUTH_NORTH = 'south_north'
    WEST_EAST = 'west_east'
    TIME = 'time'
    PRESSURE_LEVEL = 'level'
    HEIGHT = 'height'
    VARIABLE = 'variable'
    LATITUDE = 'latitude'
    LONGITUDE = 'longitude'
    QUANTILE = 'quantile'
    GLOBAL_TIME = 'global_time'

    @classmethod
    def order(cls):
        """Canonical relative ordering of all dims."""
        return (
            cls.FLATTENED_SPATIAL,
            cls.SOUTH_NORTH,
            cls.WEST_EAST,
            cls.TIME,
            cls.PRESSURE_LEVEL,
            cls.HEIGHT,
            cls.VARIABLE,
        )

    @classmethod
    def dims_2d(cls):
        """(south_north, west_east)"""
        return (cls.SOUTH_NORTH, cls.WEST_EAST)

    @classmethod
    def dims_3d(cls):
        """(south_north, west_east, time)"""
        return (cls.SOUTH_NORTH, cls.WEST_EAST, cls.TIME)

    @classmethod
    def dims_4d(cls):
        """(south_north, west_east, time, height)"""
        return (cls.SOUTH_NORTH, cls.WEST_EAST, cls.TIME, cls.HEIGHT)

    @classmethod
    def dims_4d_pres(cls):
        """(south_north, west_east, time, level)"""
        return (cls.SOUTH_NORTH, cls.WEST_EAST, cls.TIME, cls.PRESSURE_LEVEL)

    @classmethod
    def coords_2d(cls):
        """(latitude, longitude)"""
        return (cls.LATITUDE, cls.LONGITUDE)


# Aliases found in raw files → canonical feature names
FEATURE_NAMES = {
    'elevation': 'topography',
    'orog': 'topography',
    'hgt': 'topography',
}

# Aliases found in raw files → canonical coordinate names
COORD_NAMES = {
    'lat': Dimension.LATITUDE,
    'lon': Dimension.LONGITUDE,
    'xlat': Dimension.LATITUDE,
    'xlong': Dimension.LONGITUDE,
    'plev': Dimension.PRESSURE_LEVEL,
    'isobaricInhPa': Dimension.PRESSURE_LEVEL,
    'pressure_level': Dimension.PRESSURE_LEVEL,
    'xtime': Dimension.TIME,
    'time_index': Dimension.TIME,
    'valid_time': Dimension.TIME,
    'west_east': Dimension.LONGITUDE,
    'south_north': Dimension.LATITUDE,
}

# Aliases of dimension names → canonical dim names
DIM_NAMES = {
    'lat': Dimension.SOUTH_NORTH,
    'lon': Dimension.WEST_EAST,
    'xlat': Dimension.SOUTH_NORTH,
    'xlong': Dimension.WEST_EAST,
    'latitude': Dimension.SOUTH_NORTH,
    'longitude': Dimension.WEST_EAST,
    'plev': Dimension.PRESSURE_LEVEL,
    'isobaricInhPa': Dimension.PRESSURE_LEVEL,
    'pressure_level': Dimension.PRESSURE_LEVEL,
    'xtime': Dimension.TIME,
    'time_index': Dimension.TIME,
    'valid_time': Dimension.TIME,
}

# ERA5 variables available on a single (surface) level
SFC_VARS = [
    'surface_sensible_heat_flux',
    '10m_u_component_of_wind',
    '10m_v_component_of_wind',
    '100m_u_component_of_wind',
    '100m_v_component_of_wind',
    'surface_pressure',
    '2m_temperature',
    'geopotential',
    'total_precipitation',
    'convective_available_potential_energy',
    '2m_dewpoint_temperature',
    'convective_inhibition',
    'surface_latent_heat_flux',
    'instantaneous_moisture_flux',
    'mean_total_precipitation_rate',
    'mean_sea_level_pressure',
    'friction_velocity',
    'lake_cover',
    'high_vegetation_cover',
    'land_sea_mask',
    'k_index',
    'forecast_surface_roughness',
    'northward_turbulent_surface_stress',
    'eastward_turbulent_surface_stress',
    'sea_surface_temperature',
    'instantaneous_10m_wind_gust',
    'skin_temperature',
]

# ERA5 variables available on multiple pressure levels
LEVEL_VARS = [
    'u_component_of_wind',
    'v_component_of_wind',
    'geopotential',
    'temperature',
    'relative_humidity',
    'specific_humidity',
    'divergence',
    'vertical_velocity',
    'pressure',
    'potential_vorticity',
]

# Short ERA5 variable names → canonical names
ERA_NAME_MAP = {
    'u10': 'u_10m',
    'v10': 'v_10m',
    'u100': 'u_100m',
    'v100': 'v_100m',
    't': 'temperature',
    't2m': 'temperature_2m',
    'sp': 'pressure_0m',
    'r': 'relativehumidity',
    'relative_humidity': 'relativehumidity',
    'q': 'specifichumidity',
    'd': 'divergence',
}

_HEIGHT_PATTERN = re.compile(r'_\(?(\d+)\)?m$')
_PRESSURE_PATTERN = re.compile(r'_\(?(\d+)\)?pa$')


def parse_feature(feature):
    """Parse a canonical feature name into (basename, height, pressure).

    ``'u_100m'`` → ``('u', 100, None)``;
    ``'temperature_850pa'`` → ``('temperature', None, 850)``;
    ``'topography'`` → ``('topography', None, None)``.

    Mirrors the feature grammar used throughout the reference
    (reference: sup3r/preprocessing/utilities.py parse_feature helper;
    sup3r/utilities/utilities.py:78 get_feature_basename).
    """
    feature = feature.lower()
    m_h = _HEIGHT_PATTERN.search(feature)
    m_p = _PRESSURE_PATTERN.search(feature)
    if m_h:
        return feature[: m_h.start()], int(m_h.group(1)), None
    if m_p:
        return feature[: m_p.start()], None, int(m_p.group(1))
    return feature, None, None


def get_feature_basename(feature):
    """Base name of a feature without height/pressure suffix."""
    return parse_feature(feature)[0]


def uv_height_pairs(features):
    """Resolve the u/v → windspeed/winddirection inversion pairs for a
    list of output features.

    Detection mirrors the reference writer's loose case-insensitive
    match (reference: sup3r/writers/base.py:217-227,
    ``re.match('u_(.*?)m', f.lower())`` + integer height rounding),
    after which the canonical ``u_{h}m`` / ``v_{h}m`` names are looked
    up exactly. Any u-like feature that does NOT resolve to a canonical
    pair — decimal height, non-lowercase spelling, missing v partner —
    raises ValueError, the same loud outcome as the reference's
    ``features.index(...)`` calls, instead of silently leaving raw u/v
    columns in the output.

    Returns a list of ``(height, u_idx, v_idx)`` tuples.
    """
    feats = list(features)
    pairs = []
    for f in feats:
        if not re.match('u_(.*?)m', str(f).lower()):
            continue
        height = parse_feature(f)[1]
        u, v = f'u_{height}m', f'v_{height}m'
        if height is None or u not in feats or v not in feats:
            raise ValueError(
                f'Feature "{f}" looks like a u-wind component but does '
                f'not resolve to a canonical u_{{h}}m/v_{{h}}m pair in '
                f'{feats} — cannot invert u/v to windspeed/winddirection'
            )
        pairs.append((height, feats.index(u), feats.index(v)))
    return pairs


def strip_obs_suffix(feature):
    """Base feature name of an ``*_obs`` observation feature — strips
    the SUFFIX only (``str.replace`` would also eat an interior
    ``'_obs'`` in the base name, e.g. ``'u_obstacle_10m_obs'``)."""
    return feature[:-4] if feature.endswith('_obs') else feature
