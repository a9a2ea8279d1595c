"""Base data retrieval for bias calibration: pair a flattened baseline
resource (WTK/NSRDB H5, or a gridded NetCDF baseline) with a gridded
biased dataset (GCM NetCDF).

The port's copy of ``sup3r_tpu/bias/base.py`` on the pandas-free
``TimeIndex``. Reference parity: sup3r/bias/base.py:60-779 (KDTree gid
mapping :212-245, per-gid retrieval + daily reduction :367-556).
"""

import logging
import threading

import numpy as np
from scipy.spatial import cKDTree

from sup3r_tpu_torch.preprocessing.data_handlers import (
    get_input_handler_class,
)
from sup3r_tpu_torch.preprocessing.loaders import LoaderH5
from sup3r_tpu_torch.utilities.times import TimeIndex, calendar_days

logger = logging.getLogger(__name__)

#: daily reductions of ``get_base_data``
_DAILY = {'avg': np.nanmean, 'max': np.nanmax, 'min': np.nanmin,
          'sum': np.nansum, 'total': np.nansum}


def _run_gid_loop(fn, n_gids, max_workers):
    """``fn`` of every gid, serially or across threads (the reference
    fans out with a ProcessPoolExecutor, bias_calc.py:191-255; the work
    here is GIL-releasing numpy reductions on the host, so threads are
    the cheaper equivalent). No device work runs in ``fn``: that stays
    on the calling thread."""
    if max_workers == 1:
        return map(fn, range(n_gids))
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        return list(pool.map(fn, range(n_gids)))


class _FlatNCBase:
    """Adapter exposing a gridded NetCDF dataset through the flattened
    (gid-indexed) base-loader API the bias calculators use, so NetCDF
    files serve as the baseline 'observations' (reference:
    tests/bias/test_bias_correction.py:662 test_nc_base_file)."""

    def __init__(self, loader):
        self._loader = loader
        self._dset = loader.data

    @property
    def lat_lon_flat(self):
        return self._dset.lat_lon.reshape(-1, 2)

    @property
    def time_index(self):
        return self._dset.time_index

    def get(self, dset, time_slice=slice(None), gids=None):
        """(t, sites) block for flattened gid indexing."""
        arr = np.asarray(self._dset[dset], dtype=np.float32)
        flat = arr.reshape(-1, arr.shape[-1]).T
        flat = flat[time_slice]
        return flat if gids is None else flat[:, gids]

    def close(self):
        close = getattr(self._loader, 'close', None)
        if close:
            close()


class _DailyGroups:
    """The calendar days of a time index and how its stamps group into
    them, worked out once for every gid's daily reduction."""

    def __init__(self, time_index):
        day_ids = calendar_days(time_index)
        _, first = np.unique(day_ids, return_index=True)
        self.days = day_ids[np.sort(first)]
        self.day_ids = day_ids
        self.time_index = TimeIndex(self.days)
        # stamps sorted and every day equally long: a (days, per-day)
        # reshape reduces each row exactly as the per-day mask does
        counts = np.unique(day_ids, return_counts=True)[1]
        self.per_day = (int(counts[0]) if (np.diff(day_ids.astype(
            np.int64)) >= 0).all() and (counts == counts[0]).all()
            else None)

    def reduce(self, series, how):
        red = _DAILY[how]
        if self.per_day is not None:
            return red(series.reshape(len(self.days), self.per_day),
                       axis=1)
        return np.array([red(series[self.day_ids == d])
                         for d in self.days])


class DataRetrievalBase:
    """Load + spatially pair (base observations, biased model) data."""

    def __init__(self, base_fps, bias_fps, base_dset, bias_feature,
                 target=None, shape=None, base_handler='LoaderH5',
                 bias_handler='DataHandler', base_handler_kwargs=None,
                 bias_handler_kwargs=None, decimals=None,
                 match_zero_rate=False, distance_upper_bound=None):
        self.base_fps = base_fps
        self.bias_fps = bias_fps
        self.base_dset = base_dset
        self.bias_feature = bias_feature
        self.decimals = decimals
        self.match_zero_rate = match_zero_rate

        # biased data on its grid
        HandlerClass = (get_input_handler_class(bias_handler)
                        if isinstance(bias_handler, str)
                        else bias_handler)
        self.bias_dh = HandlerClass(
            bias_fps, features=[bias_feature], target=target,
            shape=shape, **(bias_handler_kwargs or {}))
        self.bias_gid_raster = np.arange(
            np.prod(self.bias_dh.lat_lon.shape[:2])).reshape(
            self.bias_dh.lat_lon.shape[:2])

        # baseline flattened resource; base_handler may be a class or
        # a name resolvable from the loaders module ('LoaderH5' etc.)
        if isinstance(base_handler, str):
            import sup3r_tpu_torch.preprocessing.loaders as _loaders

            # rex handler names from reference configs all read
            # flattened H5 resource files (reference default
            # base_handler='Resource', sup3r/bias/base.py:40)
            rex_aliases = {'resource', 'multifileresource', 'windx',
                           'multifilewindx', 'nsrdbx',
                           'multifilensrdbx'}
            if base_handler.lower() in rex_aliases:
                resolved = LoaderH5
            else:
                resolved = getattr(_loaders, base_handler, None)
            if resolved is None:
                try:
                    resolved = get_input_handler_class(base_handler)
                except KeyError:
                    resolved = None
            if resolved is None:
                raise KeyError(
                    f'Unknown base_handler "{base_handler}" — not a '
                    'loaders class, rex alias (Resource/WindX/...), '
                    'or DataHandler name')
            base_handler = resolved
        self.base_loader = base_handler(base_fps,
                                        **(base_handler_kwargs or {}))
        if not hasattr(self.base_loader, 'lat_lon_flat'):
            # gridded NC baseline: expose it through the flat gid API
            self.base_loader = _FlatNCBase(self.base_loader)
        self._map_base_gids(distance_upper_bound)
        self._daily_groups = None
        self._daily_lock = threading.Lock()

    def _map_base_gids(self, distance_upper_bound=None):
        """Assign each base site to its nearest bias grid cell."""
        bias_coords = self.bias_dh.lat_lon.reshape(-1, 2)
        tree = cKDTree(bias_coords)
        if distance_upper_bound is None:
            lat_span = float(np.ptp(bias_coords[:, 0]))
            lon_span = float(np.ptp(bias_coords[:, 1]))
            s1, s2 = self.bias_gid_raster.shape
            distance_upper_bound = np.hypot(lat_span / max(s1 - 1, 1),
                                            lon_span / max(s2 - 1, 1))
        self.distance_upper_bound = distance_upper_bound
        _, nn = tree.query(
            self.base_loader.lat_lon_flat,
            distance_upper_bound=distance_upper_bound)
        # every base site in order, grouped by its bias cell
        order = np.argsort(nn, kind='stable')
        cells, starts = np.unique(nn[order], return_index=True)
        groups = np.split(order, starts[1:])
        self.base_gid_map = {int(c): g for c, g in zip(cells, groups)
                             if c < len(bias_coords)}

    @property
    def bias_time_index(self):
        """Time index of the biased dataset."""
        return self.bias_dh.time_index

    @property
    def base_time_index(self):
        """Time index of the baseline dataset."""
        return self.base_loader.time_index

    def get_bias_data(self, bias_gid):
        """(t,) biased time series for one bias grid cell."""
        row, col = np.unravel_index(bias_gid,
                                    self.bias_gid_raster.shape)
        out = self.bias_dh.data[self.bias_feature][row, col]
        if self.decimals is not None:
            out = np.round(out, self.decimals)
        return np.asarray(out)

    @staticmethod
    def _match_zero_rate(bias_data, base_data):
        """Set the lowest-percentile biased values to zero so the bias
        data's zero rate matches the baseline's: the GCM 'drizzle
        problem' fix (Polade et al. 2014; reference:
        sup3r/bias/base.py:557-599)."""
        bias_data = np.array(bias_data, dtype=np.float32)
        q_zero_base = float(np.nanmean(base_data == 0))
        q_bias = np.linspace(0, 1, len(bias_data))
        min_value_bias = np.interp(q_zero_base, q_bias,
                                   np.sort(bias_data))
        bias_data[bias_data < min_value_bias] = 0
        logger.debug(
            'match_zero_rate: base zero rate %.3e -> bias zero rate '
            '%.3e', q_zero_base, float(np.nanmean(bias_data == 0)))
        return bias_data

    def _daily(self):
        """The base time index's day grouping, made once (the gid loop
        may call this from several threads)."""
        with self._daily_lock:
            if self._daily_groups is None:
                self._daily_groups = _DailyGroups(self.base_time_index)
            return self._daily_groups

    def get_base_data(self, bias_gid, daily_reduction='avg'):
        """(t,) baseline series for a bias cell: mean over mapped base
        sites, optionally reduced to daily values. Returns (data,
        time_index) or (None, None) when no sites map to the cell. The
        daily time index is one shared object for every gid."""
        base_gids = self.base_gid_map.get(int(bias_gid))
        if base_gids is None:
            return None, None
        block = self.base_loader.get(self.base_dset, slice(None),
                                     base_gids)
        series = np.nanmean(block, axis=1)
        ti = self.base_time_index
        if daily_reduction:
            groups = self._daily()
            series = groups.reduce(series, daily_reduction)
            ti = groups.time_index
        if self.decimals is not None:
            series = np.round(series, self.decimals)
        return series.astype(np.float32), ti

    @property
    def meta(self):
        """Run metadata."""
        return {
            'base_fps': str(self.base_fps),
            'bias_fps': str(self.bias_fps),
            'base_dset': self.base_dset,
            'bias_feature': self.bias_feature,
        }
