"""DataHandlers: Loader -> Rasterizer -> Deriver composition, and the
daily (climate-change) variants.

Reference parity: sup3r/preprocessing/data_handlers/base.py:46
(DataHandler), :293 (DailyDataHandler), :383-396 (H5WindCC / H5SolarCC).
The port's copy of the eager handlers of
``sup3r_tpu/preprocessing/data_handlers.py``, on the pandas-free
``TimeIndex``. ``mode='lazy'``, feature caching and the GCM handlers
(``DataHandlerNCforCC``, which regrids NSRDB clearsky data) come with
later slices of the port and raise ``NotImplementedError`` here.
"""

import logging

import numpy as np

from sup3r_tpu_torch.preprocessing.derivers import (
    Deriver,
    RegistryBase,
    RegistryH5SolarCC,
    RegistryH5WindCC,
)
from sup3r_tpu_torch.preprocessing.grid import GridDataset, PairedDataset
from sup3r_tpu_torch.preprocessing.rasterizers import Rasterizer

logger = logging.getLogger(__name__)

#: handler names of the JAX package that later slices of the port bring
_LATER_HANDLERS = ('DataHandlerNCforCC', 'DataHandlerNCforCCwithPowerLaw')


class DataHandler:
    """Load + rasterize + derive features for one spatiotemporal extent.

    ``.data`` is the derived GridDataset (a (daily, hourly)
    ``PairedDataset`` for the daily handlers)."""

    FEATURE_REGISTRY = RegistryBase

    def __init__(self, file_paths, features='all', target=None,
                 shape=None, time_slice=slice(None), threshold=None,
                 raster_file=None, time_roll=0, time_shift=None,
                 hr_spatial_coarsen=1, nan_method_kwargs=None,
                 interp_kwargs=None, cache_kwargs=None, res_kwargs=None,
                 FeatureRegistry=None, window=None, mode='eager'):
        self.file_paths = file_paths
        registry = FeatureRegistry or self.FEATURE_REGISTRY
        if mode != 'eager':
            raise NotImplementedError(
                f"DataHandler(mode={mode!r}): mode='lazy' streams through "
                'preprocessing/lazy.py, which comes with a later slice of '
                'the port (ROADMAP queue 1 item 5.1: chunked_io / lazy.py)')
        if cache_kwargs is not None:
            raise NotImplementedError(
                'DataHandler(cache_kwargs=...): feature caching '
                '(postprocessing/cachers.py) comes with a later slice of '
                'the port (ROADMAP queue 1 item 8)')
        self.rasterizer = Rasterizer(
            file_paths, features='all', target=target, shape=shape,
            time_slice=time_slice, threshold=threshold,
            raster_file=raster_file, res_kwargs=res_kwargs,
            window=window)
        raster_data = self.rasterizer.data
        feats = (raster_data.features if features in ('all', None)
                 else features)
        deriver = Deriver(
            raster_data, feats, time_roll=time_roll,
            time_shift=time_shift, hr_spatial_coarsen=hr_spatial_coarsen,
            nan_method_kwargs=nan_method_kwargs, FeatureRegistry=registry,
            interp_kwargs=interp_kwargs)
        self.data = deriver.data
        self._deriver_hook()

    def _deriver_hook(self):
        """Subclass hook after derivation (e.g. daily coarsening)."""

    @property
    def features(self):
        return self.data.features

    @property
    def shape(self):
        return self.data.shape

    @property
    def lat_lon(self):
        if hasattr(self.data, 'members'):
            return list(self.data.members.values())[-1].lat_lon
        return self.data.lat_lon

    @property
    def time_index(self):
        if hasattr(self.data, 'members'):
            return list(self.data.members.values())[-1].time_index
        return self.data.time_index

    def __getitem__(self, key):
        return self.data[key]


def _day_ids(time_index):
    """The calendar day of each timestamp (``datetime64[D]``)."""
    return np.asarray(time_index).astype('datetime64[D]')


def _unique_days(day_ids):
    """The distinct days in order of appearance."""
    _, first = np.unique(day_ids, return_index=True)
    return day_ids[np.sort(first)]


class DailyDataHandler(DataHandler):
    """Produces a (daily, hourly) PairedDataset: hourly data trimmed to
    whole days + daily coarsening, with max / min for the ``_max_`` /
    ``_min_`` features (temperature and RH extremes), sums for
    ``total_`` features and means for the rest (reference:
    data_handlers/base.py:293-380)."""

    @staticmethod
    def _day_steps(ti):
        """Steps per full day from the actual time step (reference:
        data_handlers/base.py:333)."""
        if len(ti) > 1:
            step = (ti[1] - ti[0]) / np.timedelta64(1, 's')
        else:
            step = 3600.0
        return max(int(round(24 * 3600 / step)), 1)

    def _deriver_hook(self):
        hourly = self.data
        ti = hourly.time_index
        assert ti is not None, 'DailyDataHandler needs a time index'
        day_ids = _day_ids(ti)
        # steps per full day from the time step: sub-hourly data has more
        # than 24 (30-min NSRDB has 48)
        day_steps = self._day_steps(ti)
        msg = (f'DailyDataHandler needs at least one full day '
               f'({day_steps} steps), got {len(ti)}')
        assert len(ti) >= day_steps, msg
        days, counts = np.unique(day_ids, return_counts=True)
        keep = np.isin(day_ids, days[counts == day_steps])
        # day_steps rows can still hold zero whole calendar days
        assert keep.any(), msg
        hourly = GridDataset(hourly.data[:, :, keep], hourly.features,
                             lat_lon=hourly.lat_lon, time_index=ti[keep])
        day_ids = day_ids[keep]
        days = _unique_days(day_ids)

        daily_arrs = []
        for i, f in enumerate(hourly.features):
            chan = hourly.data[..., i]
            parts = []
            for d in days:
                sel = chan[:, :, day_ids == d]
                if '_max_' in f:
                    parts.append(sel.max(axis=2))
                elif '_min_' in f:
                    parts.append(sel.min(axis=2))
                elif 'total_' in f:
                    parts.append(sel.sum(axis=2))
                else:
                    parts.append(sel.mean(axis=2))
            daily_arrs.append(np.stack(parts, axis=2))
        daily = GridDataset(np.stack(daily_arrs, axis=-1), hourly.features,
                            lat_lon=hourly.lat_lon,
                            time_index=days.astype('datetime64[ns]'))
        self.data = PairedDataset(daily=daily, hourly=hourly)
        self.daily = daily
        self.hourly = hourly


class DataHandlerH5WindCC(DailyDataHandler):
    """Daily / hourly wind handler for WTK H5 (reference:
    data_handlers/base.py:383)."""

    FEATURE_REGISTRY = RegistryH5WindCC


class DataHandlerH5SolarCC(DailyDataHandler):
    """Daily / hourly solar handler for NSRDB data: the daily
    clearsky_ratio is total ghi / total clearsky ghi, so ghi and
    clearsky_ghi are loaded alongside it and trimmed off after
    (reference: data_handlers/base.py:390). It takes any file its loader
    reads (NSRDB H5, or NetCDF holding ghi and clearsky_ghi)."""

    FEATURE_REGISTRY = RegistryH5SolarCC

    def __init__(self, file_paths, features='all', **kwargs):
        required = ['ghi', 'clearsky_ghi']
        self._requested_features = (
            None if features in ('all', None)
            else [x.lower() for x in features])
        if features not in ('all', None):
            lower = [x.lower() for x in features]
            missing = [f for f in required if f not in lower]
            if 'clearsky_ratio' in lower and missing:
                features = list(features) + missing
        super().__init__(file_paths, features=features, **kwargs)

    def _deriver_hook(self):
        """Daily clearsky_ratio is total ghi / total clearsky ghi, not a
        mean of hourly ratios (reference: data_handlers/base.py:341)."""
        super()._deriver_hook()
        feats = self.daily.features
        if 'clearsky_ratio' in feats and 'ghi' in feats and (
                'clearsky_ghi' in feats):
            ghi = self.daily['ghi']
            cs = self.daily['clearsky_ghi']
            with np.errstate(divide='ignore', invalid='ignore'):
                csr = np.where(cs > 0, ghi / cs, np.nan)
            self.daily.data[..., self.daily.feature_index(
                'clearsky_ratio')] = csr
        # trim the added ghi / clearsky_ghi channels back to the requested
        # features: the samplers index channels by position
        req = self._requested_features
        if req and any(f not in req for f in self.hourly.features):

            def select(ds):
                idx = [ds.feature_index(f) for f in req]
                return GridDataset(ds.data[..., idx], list(req),
                                   lat_lon=ds.lat_lon,
                                   time_index=ds.time_index)

            self.daily = select(self.daily)
            self.hourly = select(self.hourly)
            self.data = PairedDataset(daily=self.daily, hourly=self.hourly)


def get_input_handler_class(input_handler_name):
    """Resolve a handler class by name (reference:
    sup3r/preprocessing/utilities.py:38)."""
    classes = {'DataHandler': DataHandler, 'Rasterizer': Rasterizer,
               'DailyDataHandler': DailyDataHandler,
               'DataHandlerH5WindCC': DataHandlerH5WindCC,
               'DataHandlerH5SolarCC': DataHandlerH5SolarCC}
    if input_handler_name is None:
        return DataHandler
    if isinstance(input_handler_name, type):
        return input_handler_name
    if input_handler_name in _LATER_HANDLERS:
        raise NotImplementedError(
            f'Input handler "{input_handler_name}" comes with a later '
            'slice of the port (ROADMAP queue 1 item 5.5: the GCM '
            'climate-change data handlers)')
    if input_handler_name not in classes:
        raise KeyError(
            f'Unknown input handler "{input_handler_name}"; options: '
            f'{sorted(classes)}')
    return classes[input_handler_name]
