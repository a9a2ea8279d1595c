"""DataHandlers: Loader -> Rasterizer -> Deriver composition, and the
daily (climate-change) variants.

Reference parity: sup3r/preprocessing/data_handlers/base.py:46
(DataHandler), :293 (DailyDataHandler), :383-396 (H5WindCC / H5SolarCC),
nc_cc.py:24 (DataHandlerNCforCC). The port's copy of
``sup3r_tpu/preprocessing/data_handlers.py``, on the pandas-free
``TimeIndex``: eager handlers and ``mode='lazy'`` (windowed derivation,
``preprocessing/lazy.py``). Feature caching comes with a later slice of
the port and raises ``NotImplementedError`` here.
"""

import logging

import numpy as np
from scipy.spatial import cKDTree

from sup3r_tpu_torch.names import Dimension
from sup3r_tpu_torch.preprocessing.derivers import (
    Deriver,
    RegistryBase,
    RegistryH5SolarCC,
    RegistryH5WindCC,
    RegistryNCforCC,
    RegistryNCforCCwithPowerLaw,
    _Method,
)
from sup3r_tpu_torch.preprocessing.grid import GridDataset, PairedDataset
from sup3r_tpu_torch.preprocessing.loaders import LoaderH5
from sup3r_tpu_torch.preprocessing.rasterizers import Rasterizer
from sup3r_tpu_torch.utilities.times import (
    TimeIndex,
    calendar_days,
    unique_days,
)

logger = logging.getLogger(__name__)


class DataHandler:
    """Load + rasterize + derive features for one spatiotemporal extent.

    ``.data`` is the derived GridDataset (a (daily, hourly)
    ``PairedDataset`` for the daily handlers) or, with ``mode='lazy'``,
    a ``LazyGridDataset`` that derives each sampled window on demand, so
    training streams from stores larger than host RAM (the reference's
    ``mode='lazy'`` dask stores)."""

    FEATURE_REGISTRY = RegistryBase

    def __init__(self, file_paths, features='all', target=None,
                 shape=None, time_slice=slice(None), threshold=None,
                 raster_file=None, time_roll=0, time_shift=None,
                 hr_spatial_coarsen=1, nan_method_kwargs=None,
                 interp_kwargs=None, cache_kwargs=None, res_kwargs=None,
                 FeatureRegistry=None, window=None, mode='eager'):
        self.file_paths = file_paths
        registry = FeatureRegistry or self.FEATURE_REGISTRY
        if mode not in ('eager', 'lazy'):
            raise ValueError(f"mode must be 'eager' or 'lazy', got "
                             f'{mode!r}')
        if mode == 'lazy':
            self._init_lazy(
                file_paths, features, registry, target=target, shape=shape,
                time_slice=time_slice, threshold=threshold,
                raster_file=raster_file, time_roll=time_roll,
                time_shift=time_shift,
                hr_spatial_coarsen=hr_spatial_coarsen,
                nan_method_kwargs=nan_method_kwargs,
                interp_kwargs=interp_kwargs, cache_kwargs=cache_kwargs,
                res_kwargs=res_kwargs, window=window)
            return
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
        self._rasterizer_hook()
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

    def _init_lazy(self, file_paths, features, registry, time_roll,
                   hr_spatial_coarsen, cache_kwargs, time_shift,
                   nan_method_kwargs, interp_kwargs, **raster_kwargs):
        """``mode='lazy'``: a lazy rasterizer and a ``LazyGridDataset``
        over it. The options that remap or materialize the full domain
        are refused (their identity values pass)."""
        from sup3r_tpu_torch.preprocessing.lazy import LazyGridDataset

        # time_roll=1 is a real one-step roll: only 0 / None are no-ops
        unsupported = {
            k: v for k, v in (('time_roll', time_roll or 0),
                              ('hr_spatial_coarsen',
                               hr_spatial_coarsen or 1),
                              ('cache_kwargs', cache_kwargs))
            if v and not (k == 'hr_spatial_coarsen' and v == 1)}
        if unsupported:
            raise NotImplementedError(
                f"mode='lazy' does not support {sorted(unsupported)} — "
                "these materialize or remap the full domain; use "
                "mode='eager'")
        self.rasterizer = Rasterizer(file_paths, features='all',
                                     lazy=True, **raster_kwargs)
        self._rasterizer_hook()
        raster_data = self.rasterizer.data
        feats = (raster_data.features if features in ('all', None)
                 else [f.lower() for f in features])
        self.data = LazyGridDataset(
            raster_data, feats, FeatureRegistry=self._lazy_registry(registry),
            interp_kwargs=interp_kwargs,
            nan_method_kwargs=nan_method_kwargs, time_shift=time_shift)
        self._lazy_hook()

    def _rasterizer_hook(self):
        """Subclass hook after rasterization (e.g. clearsky_ghi
        injection for the GCM handlers)."""

    def _deriver_hook(self):
        """Subclass hook after derivation (e.g. daily coarsening)."""

    def _lazy_registry(self, registry):
        """Subclass hook: adapt the feature registry for windowed
        derivation (e.g. replace the full-extent night mask with a
        precomputed per-timestep table)."""
        return registry

    def _lazy_hook(self):
        """Subclass hook after lazy construction (e.g. pairing
        ``self.data`` with a lazy daily view)."""

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


class DailyDataHandler(DataHandler):
    """Produces a (daily, hourly) PairedDataset: hourly data trimmed to
    whole days + daily coarsening, with max / min for the ``_max_`` /
    ``_min_`` features (temperature and RH extremes), sums for
    ``total_`` features and means for the rest (reference:
    data_handlers/base.py:293-380).

    ``mode='lazy'`` composes a ``LazyDailyDataset`` over the lazy hourly
    view: daily coarsening windows cleanly over whole days."""

    #: lazy daily clearsky_ratio = the totals ratio (H5SolarCC)
    _LAZY_CSR_TOTALS = False

    @staticmethod
    def _day_steps(ti):
        """Steps per full day from the actual time step (reference:
        data_handlers/base.py:333)."""
        if len(ti) > 1:
            step = (ti[1] - ti[0]) / np.timedelta64(1, 's')
        else:
            step = 3600.0
        return max(int(round(24 * 3600 / step)), 1)

    def _lazy_hook(self):
        """Trim the lazy hourly view to whole days (a contiguous crop:
        day boundaries only cut at the extent's ends for contiguous time
        indexes) and pair it with a ``LazyDailyDataset``."""
        from sup3r_tpu_torch.preprocessing.lazy import LazyDailyDataset

        hourly = self.data
        ti = hourly.time_index
        assert ti is not None, 'DailyDataHandler needs a time index'
        day_ids = calendar_days(ti)
        day_steps = self._day_steps(ti)
        msg = (f'DailyDataHandler needs at least one full day '
               f'({day_steps} steps), got {len(ti)}')
        assert len(ti) >= day_steps, msg
        days, counts = np.unique(day_ids, return_counts=True)
        keep = np.isin(day_ids, days[counts == day_steps])
        assert keep.any(), msg
        idx = np.flatnonzero(keep)
        a, b = int(idx[0]), int(idx[-1]) + 1
        if b - a != len(idx):
            raise NotImplementedError(
                "mode='lazy' daily handling needs the whole-day trim to be "
                'a contiguous crop, but full days are interleaved with '
                "partial ones (gappy time index) — use mode='eager'")
        if (a, b) != (0, len(ti)):
            hourly = hourly.time_slice_view(slice(a, b))
        daily = LazyDailyDataset(
            hourly, day_steps, csr_from_totals=self._LAZY_CSR_TOTALS)
        self.data = PairedDataset(daily=daily, hourly=hourly)
        self.daily = daily
        self.hourly = hourly

    def _deriver_hook(self):
        hourly = self.data
        ti = hourly.time_index
        assert ti is not None, 'DailyDataHandler needs a time index'
        day_ids = calendar_days(ti)
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
        days = unique_days(day_ids)

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
    _LAZY_CSR_TOTALS = True

    def __init__(self, file_paths, features='all', **kwargs):
        required = ['ghi', 'clearsky_ghi']
        self._requested_features = (
            None if features in ('all', None)
            else [x.lower() for x in features])
        # lazy mode derives on demand: the lazy daily view reads ghi and
        # clearsky_ghi itself for the totals-based csr, so the helper
        # channels eager mode adds and trims are not needed
        if features not in ('all', None) and kwargs.get(
                'mode', 'eager') != 'lazy':
            lower = [x.lower() for x in features]
            missing = [f for f in required if f not in lower]
            if 'clearsky_ratio' in lower and missing:
                features = list(features) + missing
        super().__init__(file_paths, features=features, **kwargs)

    def _lazy_registry(self, registry):
        """The hourly ``clearsky_ratio``'s night mask is a full-extent
        reduction per timestep (derivers ``_clearsky_ratio``), which a
        window cannot compute. Precompute it as a per-timestep table here
        (one streamed pass over clearsky_ghi) and swap in a window-local
        csr that indexes the table by the window's raw timestamps:
        bit-identical to the eager full-domain derivation."""
        raw = self.rasterizer.data
        if 'clearsky_ghi' not in raw or raw.time_index is None:
            return registry
        var = raw.data_vars['clearsky_ghi']
        s1, s2 = raw.grid_shape
        n_t = len(raw.time_index)
        night = np.empty(n_t, dtype=bool)
        block_t = max(1, 2 ** 22 // max(s1 * s2, 1))
        for t0 in range(0, n_t, block_t):
            tsl = slice(t0, min(t0 + block_t, n_t))
            if hasattr(var, 'isel'):
                block = var.isel({Dimension.TIME: tsl})
            else:
                block = var[:, :, tsl]
            night[tsl] = (np.asarray(block) <= 1).any(axis=(0, 1))
        positions = {int(v): i for i, v in enumerate(
            np.asarray(raw.time_index).astype(np.int64))}

        def _clearsky_ratio_night_table(ctx):
            with np.errstate(divide='ignore', invalid='ignore'):
                csr = ctx['ghi'] / ctx['clearsky_ghi']
            locs = [positions.get(int(v), -1) for v in np.asarray(
                ctx.time_index).astype(np.int64)]
            assert min(locs, default=0) >= 0, (
                'window timestamps not in raster')
            csr[..., night[locs]] = np.nan
            return csr.astype(np.float32)

        return {**registry,
                'clearsky_ratio': _Method(_clearsky_ratio_night_table,
                                          ('ghi', 'clearsky_ghi'))}

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


class DataHandlerNCforCC(DataHandler):
    """GCM netcdf handler: optionally regrids NSRDB clearsky_ghi onto
    the GCM grid with daily-mean coarsening and rsds max-scaling
    (reference: data_handlers/nc_cc.py:24-243)."""

    FEATURE_REGISTRY = RegistryNCforCC

    def __init__(self, file_paths, features='all', nsrdb_source_fp=None,
                 nsrdb_agg=1, nsrdb_smoothing=0, clearsky_scale=None,
                 **kwargs):
        self._nsrdb_source_fp = nsrdb_source_fp
        self._nsrdb_agg = nsrdb_agg
        self._nsrdb_smoothing = nsrdb_smoothing
        #: precomputed per-pixel rsds/cs time-max ratio raster (or a
        #: legacy scalar, or an .npy path); windowed handlers
        #: (chunked_io) must use the full-time-axis factors, not
        #: window-local ones, or chunk outputs diverge from the eager
        #: path (reference: nc_cc.py:231-240 scale_clearsky_ghi is
        #: per spatial pixel over the FULL time axis)
        self._clearsky_scale = clearsky_scale
        self._features_req = features
        super().__init__(file_paths, features=features, **kwargs)

    def _rasterizer_hook(self):
        feats = self._features_req
        need_cs = feats not in ('all', None) and any(
            f.lower() in ('clearsky_ratio', 'clearsky_ghi')
            for f in feats)
        if not (need_cs and self._nsrdb_source_fp is not None):
            return
        if getattr(self.rasterizer, 'lazy', False):
            self._inject_lazy_clearsky()
            return
        self.rasterizer.data.data_vars['clearsky_ghi'] = (
            self.get_clearsky_ghi())
        self.rasterizer.data.var_dims['clearsky_ghi'] = (
            'south_north', 'west_east', 'time')

    def _inject_lazy_clearsky(self):
        """Lazy clearsky_ghi: precompute ONCE (a) the per-pixel NSRDB
        daily clearsky table + gcm-step row mapping and (b) the
        full-extent per-pixel scale raster (streamed rsds time-max /
        table time-max, or the given ``clearsky_scale``), then
        register a windowed-read variable whose reads are pure array
        indexing. Without the table, every lazily sampled window
        re-ran the full regrid (NSRDB open + KDTree over all sites +
        whole-year daily means) in the sampler hot path. Host memory
        stays bounded: the table is (n_days <= 366, s1, s2) float32 —
        1/365th of one year of full-domain hourly data — and the rsds
        scale pass streams in time blocks."""
        from sup3r_tpu_torch.preprocessing.lazy import _LazyClearskyGHI

        if self._nsrdb_smoothing:
            raise NotImplementedError(
                "nsrdb_smoothing is not supported with mode='lazy' "
                '(window-local smoothing diverges at window borders); '
                "use mode='eager' or nsrdb_smoothing=0")
        raw = self.rasterizer.data
        gcm_ti = raw.time_index
        lat_lon = self.rasterizer.lat_lon
        s1, s2 = self.rasterizer.grid_shape
        table, rows = self._clearsky_daily_table(lat_lon, gcm_ti)
        scale = self._clearsky_scale
        if isinstance(scale, str):
            scale = np.load(scale)
        if scale is None and 'rsds' in raw:
            scale = self._full_extent_clearsky_scale(raw, table, rows)
        if isinstance(scale, np.ndarray) and scale.ndim == 2:
            if scale.shape != (s1, s2):
                raise ValueError(
                    f'clearsky_scale raster shape {scale.shape} does '
                    f'not match handler grid {(s1, s2)}; chunked_io '
                    'callers must window the raster to the handler')
        raw.data_vars['clearsky_ghi'] = _LazyClearskyGHI(
            table, rows, scale)
        raw.var_dims['clearsky_ghi'] = (
            'south_north', 'west_east', 'time')

    def _clearsky_daily_table(self, lat_lon, gcm_ti):
        """Per-pixel NSRDB daily clearsky curve for the FULL handler
        grid, computed once (loader + KDTree built once, site columns
        read per point block), plus the gcm-step -> table-row mapping.
        Returns ``(table (n_days, s1, s2) float32, rows (n_t,) int)``.
        Per-point math is identical to ``_regrid_clearsky`` so window
        reads are bit-equal to the eager injection."""
        s1g, s2g = lat_lon.shape[:2]
        pts = lat_lon.reshape(-1, 2)
        nsrdb = LoaderH5(self._nsrdb_source_fp)
        nsrdb_ti = nsrdb.time_index
        tree = cKDTree(nsrdb.lat_lon_flat)
        day_ids = calendar_days(nsrdb_ti)
        days = unique_days(day_ids)
        day_masks = [day_ids == d for d in days]
        table = np.empty((len(days), len(pts)), dtype=np.float32)
        # bound the (t_nsrdb, n_uniq_sites) column read per block
        block_p = max(1, 2 ** 22 // max(len(nsrdb_ti), 1))
        for i0 in range(0, len(pts), block_p):
            _, idx = tree.query(pts[i0:i0 + block_p],
                                k=self._nsrdb_agg)
            if idx.ndim == 1:
                idx = idx[:, None]
            uniq = np.unique(idx)
            cs_ghi = nsrdb.get('clearsky_ghi', gids=uniq)
            pos = np.searchsorted(uniq, idx)
            agg = cs_ghi[:, pos].mean(axis=-1)  # (t, n_block)
            for j, m in enumerate(day_masks):
                table[j, i0:i0 + block_p] = agg[m].mean(axis=0)
        rows = self._gcm_day_rows(days, gcm_ti)
        return table.reshape(len(days), s1g, s2g), rows

    def _full_extent_clearsky_scale(self, raw, table, rows):
        """Per-pixel ``rsds.max(time) / cs.max(time)`` over the FULL
        extent (reference nc_cc.py:231-240): rsds streamed in time
        blocks; the cs time-max is the max over the daily-table rows
        the gcm time index actually uses — bit-equal to the eager
        ratio (max is associative)."""
        s1, s2 = raw.grid_shape
        rsds = raw.data_vars['rsds']
        n_t = rsds.shape[-1]
        rsds_max = np.full((s1, s2), -np.inf, dtype=np.float32)
        block_t = max(1, 2 ** 22 // max(s1 * s2, 1))
        with np.errstate(invalid='ignore'):
            for t0 in range(0, n_t, block_t):
                tsl = slice(t0, min(t0 + block_t, n_t))
                if hasattr(rsds, 'isel'):
                    block = rsds.isel({Dimension.TIME: tsl})
                else:
                    block = rsds[:, :, tsl]
                rsds_max = np.fmax(
                    rsds_max, np.nanmax(np.asarray(block), axis=-1))
        cs_max = np.nanmax(table[np.unique(rows)], axis=0)
        return rsds_max / np.maximum(cs_max, 1e-6)

    def get_clearsky_ghi(self):
        """Regrid NSRDB clearsky_ghi to the GCM grid: KDTree agg of
        nsrdb_agg nearest sites, daily mean, scaled PER SPATIAL PIXEL
        so its time-max matches the rsds time-max at that pixel
        (reference: nc_cc.py:160-241; scale_clearsky_ghi at :231-240
        is ``rsds.max(dim='time') / cs.max(dim='time')``). When a
        precomputed ``clearsky_scale`` (raster windowed to this
        handler, an .npy path, or a legacy scalar) was given
        (chunked_io streaming), it is applied instead of a
        window-local ratio."""
        gcm_ti = self.rasterizer.data.time_index
        out = self._regrid_clearsky(
            self._nsrdb_source_fp, self._nsrdb_agg,
            self.rasterizer.lat_lon.reshape(-1, 2), gcm_ti)
        s1, s2 = self.rasterizer.grid_shape
        cs = out.T.reshape(s1, s2, len(gcm_ti))
        # the scale is computed from the UNSMOOTHED raster so it
        # matches the factors the chunked_io path stashes
        # (strategy._set_chunked_clearsky_scale regrids unsmoothed)
        scale = self._clearsky_scale
        if isinstance(scale, str):
            scale = np.load(scale)
        if scale is None and 'rsds' in self.rasterizer.data:
            rsds_max = np.nanmax(
                np.asarray(self.rasterizer.data['rsds']), axis=-1)
            scale = rsds_max / np.maximum(
                np.nanmax(cs, axis=-1), 1e-6)
        if isinstance(scale, np.ndarray) and scale.ndim == 2:
            if scale.shape != (s1, s2):
                raise ValueError(
                    f'clearsky_scale raster shape {scale.shape} does '
                    f'not match handler grid {(s1, s2)}; chunked_io '
                    'callers must window the raster to the handler')
            scale = scale[:, :, None]
        if self._nsrdb_smoothing:
            if self._clearsky_scale is not None:
                # window-local smoothing diverges from the full-domain
                # smoothed raster at window borders — exactly the
                # chunked-vs-eager mismatch clearsky_scale prevents
                raise NotImplementedError(
                    'nsrdb_smoothing is not supported with chunked_io '
                    'streaming (per-window smoothing would diverge at '
                    'window borders); run without chunked_io or with '
                    'nsrdb_smoothing=0')
            # documented upstream (nc_cc.py:58-60) but never applied
            # there — here the gaussian smoothing actually runs
            from scipy.ndimage import gaussian_filter

            cs = gaussian_filter(
                cs, sigma=(self._nsrdb_smoothing,
                           self._nsrdb_smoothing, 0), mode='nearest')
        if scale is not None:
            cs = cs * scale
        return cs.astype(np.float32)

    @staticmethod
    def _regrid_clearsky(nsrdb_fp, nsrdb_agg, target_grid, gcm_ti):
        """UNSCALED NSRDB clearsky_ghi on arbitrary target points:
        KDTree agg of the nsrdb_agg nearest sites per point, daily
        mean, mapped to each gcm step by day-of-year. Returns
        (len(gcm_ti), n_points) float32. Point-separable, so callers
        may block over target points (reference: nc_cc.py:160-231)."""
        nsrdb = LoaderH5(nsrdb_fp)
        nsrdb_ti = nsrdb.time_index
        tree = cKDTree(nsrdb.lat_lon_flat)
        _, idx = tree.query(np.asarray(target_grid), k=nsrdb_agg)
        if idx.ndim == 1:
            idx = idx[:, None]
        # read only the site columns this window actually aggregates —
        # the full NSRDB extent can be orders of magnitude larger than
        # the KDTree-selected neighborhood (round-3 review finding)
        uniq = np.unique(idx)
        cs_ghi = nsrdb.get('clearsky_ghi', gids=uniq)  # (t, n_uniq)
        pos = np.searchsorted(uniq, idx)
        agg = cs_ghi[:, pos].mean(axis=-1)  # (t, n_points)

        # daily means aligned to gcm time index
        day_ids = calendar_days(nsrdb_ti)
        days = unique_days(day_ids)
        daily = np.stack([agg[day_ids == d].mean(axis=0) for d in days])
        rows = DataHandlerNCforCC._gcm_day_rows(days, gcm_ti)
        return daily[rows].astype(np.float32)

    @staticmethod
    def _gcm_day_rows(days, gcm_ti):
        """Map each gcm step to a row of the NSRDB daily table —
        '%m.%d' string keys like the reference (nc_cc.py:216-223):
        dayofyear shifts by one after Feb in leap years, silently
        misaligning the whole spring/summer clearsky curve. Returns
        an (len(gcm_ti),) int row index array."""
        days = TimeIndex(np.asarray(days).astype('datetime64[ns]'))
        gcm_ti = TimeIndex(gcm_ti)

        def keys(ti):
            return [f'{m:02d}.{d:02d}' for m, d in zip(ti.month, ti.day)]

        key_order = {k: i for i, k in enumerate(keys(days))}
        gcm_keys = keys(gcm_ti)
        rows = np.empty(len(gcm_ti), dtype=np.intp)
        missing = set()
        doy_nsrdb = np.asarray(days.dayofyear)
        gcm_doy = np.asarray(gcm_ti.dayofyear)
        for i, k in enumerate(gcm_keys):
            j = key_order.get(k)
            if j is None:
                # day absent from the NSRDB year (e.g. GCM leap day vs
                # a non-leap NSRDB year): use the nearest calendar day
                # instead of the reference's NaN reindex, which would
                # poison clearsky_ratio for that day
                j = int(np.argmin(np.minimum(
                    np.abs(doy_nsrdb - gcm_doy[i]),
                    365 - np.abs(doy_nsrdb - gcm_doy[i]))))
                missing.add(k)
            rows[i] = j
        if missing:
            logger.warning(
                'NSRDB source has no data for GCM calendar day(s) %s; '
                'used the nearest available day', sorted(missing))
        return rows


class DataHandlerNCforCCwithPowerLaw(DataHandlerNCforCC):
    """NCforCC with power-law near-surface wind extrapolation
    (reference: nc_cc.py:243)."""

    FEATURE_REGISTRY = RegistryNCforCCwithPowerLaw


def get_input_handler_class(input_handler_name):
    """Resolve a handler class by name (reference:
    sup3r/preprocessing/utilities.py:38)."""
    classes = {'DataHandler': DataHandler, 'Rasterizer': Rasterizer,
               'DailyDataHandler': DailyDataHandler,
               'DataHandlerH5WindCC': DataHandlerH5WindCC,
               'DataHandlerH5SolarCC': DataHandlerH5SolarCC,
               'DataHandlerNCforCC': DataHandlerNCforCC,
               'DataHandlerNCforCCwithPowerLaw':
                   DataHandlerNCforCCwithPowerLaw}
    if input_handler_name is None:
        return DataHandler
    if isinstance(input_handler_name, type):
        return input_handler_name
    if input_handler_name not in classes:
        raise KeyError(
            f'Unknown input handler "{input_handler_name}"; options: '
            f'{sorted(classes)}')
    return classes[input_handler_name]
