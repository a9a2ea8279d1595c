"""Feature derivation: regex registries + recursive derivation +
vertical level interpolation.

Reference parity: sup3r/preprocessing/derivers/base.py (derive :208,
check_registry :83-147, do_level_interpolation :352, time_roll /
hr_spatial_coarsen / nan post-ops :413-501) and methods.py (the
DerivedFeature classes + registries :504-555). The port's copy of
``sup3r_tpu/preprocessing/derivers.py`` with the base registry and the
H5 climate-change handlers' (``RegistryH5WindCC``, ``RegistryH5SolarCC``);
``RegistryNCforCC`` comes with ``DataHandlerNCforCC``.
"""

import logging
import re
from warnings import warn

import numpy as np

from sup3r_tpu_torch.names import Dimension, parse_feature
from sup3r_tpu_torch.ops.coarsen import spatial_coarsening
from sup3r_tpu_torch.ops.interp import interp_to_level
from sup3r_tpu_torch.ops.solar_pos import solar_zenith
from sup3r_tpu_torch.ops.wind import invert_uv, transform_rotate_wind
from sup3r_tpu_torch.preprocessing.grid import GridDataset
from sup3r_tpu_torch.preprocessing.loaders import RawDataset

logger = logging.getLogger(__name__)


def _wildcard(pattern, feature):
    """Map a '(.*)'-style inputs pattern to the feature's height or
    pressure suffix."""
    if '(.*)' not in pattern:
        return pattern
    base = pattern.split('_(.*)')[0]
    _, height, pressure = parse_feature(feature)
    if height is not None:
        return f'{base}_{height}m'
    if pressure is not None:
        return f'{base}_{pressure}pa'
    return base


# ----------------------------------------------------------------------
# derived feature compute functions: fn(ctx, **{height|pressure}) where
# ctx is the _DeriverContext (supports __getitem__, lat_lon, time_index)
def _surface_rh(ctx):
    """RH (0-100) from dewpoint + temperature (Magnus formula)."""
    wvp = 6.1078 * np.exp(17.1 * ctx['d2m'] / (235 + ctx['d2m']))
    svp = 6.1078 * np.exp(
        17.1 * ctx['temperature_2m'] / (235 + ctx['temperature_2m']))
    return 100 * wvp / svp


def _clearsky_ratio(ctx):
    """ghi / clearsky_ghi, NaN for any timestep with nighttime."""
    night = np.asarray((ctx['clearsky_ghi'] <= 1).any(axis=(0, 1)))
    with np.errstate(divide='ignore', invalid='ignore'):
        csr = ctx['ghi'] / ctx['clearsky_ghi']
    csr[..., night] = np.nan
    return csr.astype(np.float32)


def _clearsky_ratio_cc(ctx):
    """Daily-average clearsky ratio for GCM data, clipped to [0, 1]."""
    csr = ctx['rsds'] / ctx['clearsky_ghi']
    return np.clip(csr, 0, 1).astype(np.float32)


def _cloud_mask(ctx):
    """1 where cloudy, 0 clear, NaN nighttime."""
    night = np.asarray((ctx['clearsky_ghi'] <= 1).any(axis=(0, 1)))
    mask = (ctx['ghi'] < ctx['clearsky_ghi']).astype(np.float32)
    mask[..., night] = np.nan
    return mask


def _windspeed(ctx, height):
    """Windspeed via the grid-rotation-aware inversion — the inverse
    of the u/v derivation below, like the reference (methods.py:180
    Windspeed -> invert_uv); a plain hypot matches only on
    east-aligned regular grids."""
    ws, _ = invert_uv(ctx[f'u_{height}m'], ctx[f'v_{height}m'],
                      ctx.lat_lon)
    return np.asarray(ws)


def _winddirection(ctx, height):
    """Meteorological direction via the grid-rotation-aware inversion
    (reference: methods.py:197 Winddirection -> invert_uv) — raw
    arctan2(u, v) would be wrong by the local grid angle on
    curvilinear (e.g. Lambert WTK) grids."""
    _, wd = invert_uv(ctx[f'u_{height}m'], ctx[f'v_{height}m'],
                      ctx.lat_lon)
    return np.asarray(wd)


def _uwind(ctx, height):
    """Grid-aligned u from (windspeed, winddirection)."""
    u, _ = transform_rotate_wind(ctx[f'windspeed_{height}m'],
                                 ctx[f'winddirection_{height}m'],
                                 ctx.lat_lon)
    return u


def _vwind(ctx, height):
    """Grid-aligned v from (windspeed, winddirection)."""
    _, v = transform_rotate_wind(ctx[f'windspeed_{height}m'],
                                 ctx[f'winddirection_{height}m'],
                                 ctx.lat_lon)
    return v


def _usolar(ctx):
    """Grid-aligned u from NSRDB wind_speed / wind_direction."""
    u, _ = transform_rotate_wind(ctx['wind_speed'], ctx['wind_direction'],
                                 ctx.lat_lon)
    return u


def _vsolar(ctx):
    """Grid-aligned v from NSRDB wind_speed / wind_direction."""
    _, v = transform_rotate_wind(ctx['wind_speed'], ctx['wind_direction'],
                                 ctx.lat_lon)
    return v


def _sza(ctx):
    """Solar zenith angle raster (degrees)."""
    return solar_zenith(ctx.time_index, ctx.lat_lon)


def _latitude_feature(ctx):
    lat = ctx.lat_lon[..., 0]
    return np.repeat(lat[:, :, None], len(ctx.time_index), axis=2)


def _longitude_feature(ctx):
    lon = ctx.lat_lon[..., 1]
    return np.repeat(lon[:, :, None], len(ctx.time_index), axis=2)


def _time_encoding(ctx, seconds_fn, d, i=1):
    # i=1 (cos of the SECOND harmonic, 12-hour/half-year period) is
    # the reference's own default (methods.py SecondOfDayEncoding /
    # SecondOfYearEncoding compute(cls, data, i=1)) — looks like a
    # bug there, but parity wins; don't "fix" to i=0
    t = ctx.time_index
    k = np.asarray(seconds_fn(t), dtype=np.float64)
    k = 2 * np.pi * (i + 1) * k / d
    k = np.sin(k) if i % 2 == 0 else np.cos(k)
    out = np.broadcast_to(
        k[None, None, :], (*ctx.lat_lon.shape[:2], len(t)))
    return out.astype(np.float32)


def _sod_encoding(ctx):
    """Second-of-day sinusoidal encoding."""
    return _time_encoding(
        ctx, lambda t: t.hour * 3600 + t.minute * 60 + t.second, 86400)


def _soy_encoding(ctx):
    """Second-of-year sinusoidal encoding."""
    return _time_encoding(
        ctx, lambda t: (t.dayofyear - 1) * 86400 + t.hour * 3600
        + t.minute * 60 + t.second, 31536000)


class _Method:
    """A derivation method: compute fn + required input patterns."""

    def __init__(self, fn, inputs=()):
        self.fn = fn
        self.inputs = tuple(inputs)

    def __call__(self, ctx, **kwargs):
        return self.fn(ctx, **kwargs)


RegistryBase = {
    'u_(.*)': _Method(_uwind, ('windspeed_(.*)', 'winddirection_(.*)')),
    'v_(.*)': _Method(_vwind, ('windspeed_(.*)', 'winddirection_(.*)')),
    'relativehumidity_2m': _Method(_surface_rh, ('d2m',
                                                 'temperature_2m')),
    'windspeed_(.*)': _Method(_windspeed, ('u_(.*)', 'v_(.*)')),
    'winddirection_(.*)': _Method(_winddirection, ('u_(.*)', 'v_(.*)')),
    'cloud_mask': _Method(_cloud_mask, ('ghi', 'clearsky_ghi')),
    'clearsky_ratio': _Method(_clearsky_ratio, ('ghi', 'clearsky_ghi')),
    'sza': _Method(_sza),
    'latitude_feature': _Method(_latitude_feature),
    'longitude_feature': _Method(_longitude_feature),
    'sod_encoding': _Method(_sod_encoding),
    'soy_encoding': _Method(_soy_encoding),
}

_POWER_LAW_ALPHA = 0.2
_NEAR_SFC_HEIGHT = 10


def _u_power_law(ctx, height):
    """Power-law extrapolation of near-surface u (uas)."""
    return ctx['uas'] * (float(height) / _NEAR_SFC_HEIGHT
                         ) ** _POWER_LAW_ALPHA


def _v_power_law(ctx, height):
    """Power-law extrapolation of near-surface v (vas)."""
    return ctx['vas'] * (float(height) / _NEAR_SFC_HEIGHT
                         ) ** _POWER_LAW_ALPHA


def _temp_ncforcc(ctx, height):
    """ta_*m Kelvin -> Celsius."""
    return ctx[f'ta_{height}m'] - 273.15


def _tas(ctx):
    return ctx['tas'] - 273.15


def _tasmin(ctx):
    return ctx['tasmin'] - 273.15


def _tasmax(ctx):
    return ctx['tasmax'] - 273.15


#: the daily climate-change handlers' registries: daily extremes come from
#: the hourly field they name (the daily coarsening takes their max / min)
RegistryH5WindCC = {
    **RegistryBase,
    'temperature_max_(.*)m': 'temperature_(.*)m',
    'temperature_min_(.*)m': 'temperature_(.*)m',
    'relativehumidity_max_(.*)m': 'relativehumidity_(.*)m',
    'relativehumidity_min_(.*)m': 'relativehumidity_(.*)m',
}

RegistryH5SolarCC = {
    **RegistryH5WindCC,
    'windspeed': 'wind_speed',
    'winddirection': 'wind_direction',
    'u': _Method(_usolar, ('wind_speed', 'wind_direction')),
    'v': _Method(_vsolar, ('wind_speed', 'wind_direction')),
}

#: the GCM handlers' registries (reference: derivers/methods.py:530-555)
RegistryNCforCC = {
    **RegistryBase,
    'u_(.*)': 'ua_(.*)',
    'v_(.*)': 'va_(.*)',
    'relativehumidity_2m': 'hurs',
    'relativehumidity_min_2m': 'hursmin',
    'relativehumidity_max_2m': 'hursmax',
    'clearsky_ratio': _Method(_clearsky_ratio_cc,
                              ('rsds', 'clearsky_ghi')),
    'temperature_(.*)': _Method(_temp_ncforcc, ('ta_(.*)',)),
    'temperature_2m': _Method(_tas, ('tas',)),
    'temperature_max_2m': _Method(_tasmax, ('tasmax',)),
    'temperature_min_2m': _Method(_tasmin, ('tasmin',)),
    'pressure_(.*)': 'level_(.*)',
}

RegistryNCforCCwithPowerLaw = {
    **RegistryNCforCC,
    'u_(.*)': _Method(_u_power_law, ('uas',)),
    'v_(.*)': _Method(_v_power_law, ('vas',)),
}


class Deriver:
    """Derive requested features from rasterized data, producing a
    GridDataset."""

    FEATURE_REGISTRY = RegistryBase

    def __init__(self, data, features, time_roll=0, time_shift=None,
                 hr_spatial_coarsen=1, nan_method_kwargs=None,
                 FeatureRegistry=None, interp_kwargs=None):
        """``data``: RawDataset (from a Rasterizer) or GridDataset."""
        if FeatureRegistry is not None:
            self.FEATURE_REGISTRY = FeatureRegistry
        self.interp_kwargs = interp_kwargs or {}
        if isinstance(data, GridDataset):
            data = RawDataset(
                {f: data[f] for f in data.features},
                {f: Dimension.dims_3d() for f in data.features},
                data.lat_lon, time_index=data.time_index)
        self.raw = data
        self.lat_lon = data.lat_lon
        self.time_index = data.time_index

        features = [f.lower() for f in features]
        self._explode_levels()
        for f in features:
            if f not in self.raw:
                self.raw.data_vars[f] = np.asarray(
                    self.derive(f), dtype=np.float32)
                self.raw.var_dims[f] = Dimension.dims_3d()

        if features:
            out = np.stack(
                [self._time_full(self.raw[f]) for f in features],
                axis=-1)
        else:
            t = 0 if self.time_index is None else len(self.time_index)
            out = np.zeros((*self.lat_lon.shape[:2], t, 0),
                           dtype=np.float32)
        self.data = GridDataset(out, features, lat_lon=self.lat_lon,
                                time_index=self.time_index)

        if time_roll != 0:
            self.data.data = np.roll(self.data.data, time_roll, axis=2)
        if time_shift is not None:
            self.data.time_index = self.data.time_index.shift(
                time_shift, freq='min')
        if hr_spatial_coarsen > 1:
            hsc = hr_spatial_coarsen
            s1 = (self.data.shape[0] // hsc) * hsc
            s2 = (self.data.shape[1] // hsc) * hsc
            self.data = GridDataset(
                spatial_coarsening(self.data.data[:s1, :s2], hsc,
                                   obs_axis=False),
                self.data.features,
                lat_lon=spatial_coarsening(
                    self.data.lat_lon[:s1, :s2], hsc, obs_axis=False),
                time_index=self.data.time_index)
        if nan_method_kwargs is not None:
            self._handle_nans(nan_method_kwargs)

    # ------------------------------------------------------------------
    def _time_full(self, arr):
        """Broadcast time-independent (s1, s2) arrays over time."""
        if arr.ndim == 2 and self.time_index is not None:
            return np.repeat(arr[:, :, None], len(self.time_index),
                             axis=2)
        return arr

    def _explode_levels(self):
        """Expose multi-level vars both as base arrays (for interp) and
        keep (s1, s2, t, level) layout."""

    def _handle_nans(self, kwargs):
        method = kwargs.get('method', 'nearest')
        if method == 'mask':
            arr = self.data.data
            mask = np.isnan(arr).any(axis=(0, 1, 3))
            keep = ~mask
            self.data = GridDataset(
                arr[:, :, keep], self.data.features,
                lat_lon=self.data.lat_lon,
                time_index=self.data.time_index[keep])
        elif np.isnan(self.data.data).any():
            self.data.interpolate_na()

    # ------------------------------------------------------------------
    # registry machinery
    def _check_registry(self, feature):
        if feature in self.FEATURE_REGISTRY:
            return self.FEATURE_REGISTRY[feature]
        for pattern, method in self.FEATURE_REGISTRY.items():
            if re.fullmatch(pattern.lower(), feature.lower()):
                return method
        return None

    def _get_inputs(self, feature, method=None):
        method = method or self._check_registry(feature)
        return [_wildcard(i, feature)
                for i in getattr(method, 'inputs', [])]

    def _nested_inputs(self, feature):
        inputs = self._get_inputs(feature)
        more = []
        for i in inputs:
            more.extend(self._get_inputs(i))
        return inputs + more

    def _no_overlap(self, feature):
        return feature not in self._nested_inputs(feature)

    def has_interp_variables(self, feature):
        """Whether feature can come from level interpolation (multiple
        single-level siblings or a multi-level base var)."""
        base, _, _ = parse_feature(feature)
        count = 0
        for f in self.raw.features:
            fb, h, p = parse_feature(f)
            if fb == base and (h is not None or p is not None):
                count += 1
        return count > 1 or base in self.raw

    def derive(self, feature):
        """Derive one feature (recursively)."""
        feature = feature.lower()
        if feature in self.raw:
            arr = self.raw[feature]
            if np.isnan(arr).any():
                warn(f'Feature "{feature}" contains NaN values')
            return arr

        method = self._check_registry(feature)
        if isinstance(method, str):
            new_name = self._map_new_name(feature, method)
            return self.derive(new_name)

        if method is not None:
            inputs = self._get_inputs(feature, method)
            missing = [f for f in inputs if f not in self.raw]
            can_derive = all(
                self._no_overlap(m) or self.has_interp_variables(m)
                for m in missing)
            if missing and can_derive:
                for m in missing:
                    self.raw.data_vars[m] = np.asarray(
                        self.derive(m), dtype=np.float32)
                    self.raw.var_dims[m] = Dimension.dims_3d()
            if not missing or all(f in self.raw for f in missing):
                kwargs = {}
                base, height, pressure = parse_feature(feature)
                import inspect

                params = inspect.signature(method.fn).parameters
                if 'height' in params:
                    kwargs['height'] = height
                if 'pressure' in params:
                    kwargs['pressure'] = pressure
                return method(_DeriverContext(self), **kwargs)

        base, _, pressure = parse_feature(feature)
        if (base == 'level' and pressure is not None
                and base not in self.raw
                and self.raw.levels is not None):
            # the level COORDINATE as a feature: RegistryNCforCC maps
            # 'pressure_(.*)' -> 'level_(.*)' (reference
            # methods.py:543), which the reference resolves through
            # xarray's level coordinate variable — interpolating the
            # identity level field to pressure X yields X everywhere
            s1, s2 = self.raw.lat_lon.shape[:2]
            t = (len(self.raw.time_index)
                 if self.raw.time_index is not None else 1)
            return np.full((s1, s2, t), np.float32(pressure),
                           np.float32)

        if self.has_interp_variables(feature):
            return self.do_level_interpolation(feature)

        raise RuntimeError(
            f'Could not find "{feature}" in data '
            f'({self.raw.features}) or derive it with registry '
            f'{list(self.FEATURE_REGISTRY)}')

    @staticmethod
    def _map_new_name(feature, pattern):
        _, height, pressure = parse_feature(feature)
        pbase = pattern.split('_(.*)')[0]
        if '(.*)' not in pattern:
            return pattern
        if height is not None:
            return f'{pbase}_{height}m'
        if pressure is not None:
            return f'{pbase}_{pressure}pa'
        raise RuntimeError(
            f'Pattern "{pattern}" matched "{feature}" but no valid new '
            'name could be built')

    # ------------------------------------------------------------------
    def do_level_interpolation(self, feature):
        """Interpolate feature at a height/pressure from multi-level
        and/or single-level sibling data (reference:
        derivers/base.py:352-430)."""
        base, height, pressure = parse_feature(feature)
        level = np.float32(height if height is not None else pressure)

        ml_var = ml_lev = None
        if base in self.raw:
            ml_var = np.asarray(self.raw[base], dtype=np.float32)
            dims = self.raw.dims(base)
            if Dimension.PRESSURE_LEVEL in dims:
                # reorder to (..., level) last
                ax = dims.index(Dimension.PRESSURE_LEVEL)
                ml_var = np.moveaxis(ml_var, ax, -1)
            if height is not None:
                assert 'zg' in self.raw and 'topography' in self.raw, (
                    f'Interpolating {base} to height {height}m requires '
                    '"zg" and "topography"')
                zg = np.asarray(self.raw['zg'], dtype=np.float32)
                zg_dims = self.raw.dims('zg')
                if Dimension.PRESSURE_LEVEL in zg_dims:
                    ax = zg_dims.index(Dimension.PRESSURE_LEVEL)
                    zg = np.moveaxis(zg, ax, -1)
                topo = self._time_full(np.asarray(self.raw['topography']))
                ml_lev = zg - topo[..., None]
            else:
                assert self.raw.levels is not None, (
                    f'Interpolating {base} to pressure {pressure}pa '
                    'requires a level coordinate')
                ml_lev = np.broadcast_to(
                    self.raw.levels.astype(np.float32), ml_var.shape)

        sl_var = sl_lev = None
        sl_vars, sl_levs = [], []
        for f in self.raw.features:
            fb, h, p = parse_feature(f)
            lev = h if h is not None else p
            if fb == base and lev is not None:
                sl_vars.append(self._time_full(self.raw[f]))
                sl_levs.append(np.float32(lev))
        if sl_vars:
            sl_var = np.stack(sl_vars, axis=-1)
            sl_lev = np.broadcast_to(
                np.asarray(sl_levs, dtype=np.float32), sl_var.shape)

        if ml_var is not None and sl_var is not None:
            var_array = np.concatenate([ml_var, sl_var], axis=-1)
            lev_array = np.concatenate([ml_lev, sl_lev], axis=-1)
        elif ml_var is not None:
            var_array, lev_array = ml_var, ml_lev
        elif sl_var is not None:
            var_array, lev_array = sl_var, sl_lev
        else:
            raise RuntimeError(
                f'No single- or multi-level data found for {feature}')

        # NaN levels (e.g. below-surface ERA5 heights) are handled by
        # interp_to_level's finite gating (masked-candidate semantics
        # like the reference Interpolator) — nn-filling them here
        # would inject duplicate neighbor levels and skew the
        # two-closest-level selection (reference: derivers/base.py:379
        # only warns)
        out = interp_to_level(
            lev_array, var_array, level,
            method=self.interp_kwargs.get('method', 'linear'))
        assert not np.isnan(out).any(), (
            f'NaNs in interpolated output for {feature}')
        return np.asarray(out, dtype=np.float32)


class _DeriverContext:
    """What a derivation method sees: feature access + coords."""

    def __init__(self, deriver):
        self._d = deriver
        self.lat_lon = deriver.lat_lon
        self.time_index = deriver.time_index

    def __getitem__(self, feature):
        feature = feature.lower()
        if feature not in self._d.raw:
            self._d.raw.data_vars[feature] = np.asarray(
                self._d.derive(feature), dtype=np.float32)
            self._d.raw.var_dims[feature] = Dimension.dims_3d()
        return self._d._time_full(self._d.raw[feature])

    def __contains__(self, feature):
        return feature.lower() in self._d.raw
