"""Streaming (lazy) data plane: the port of
``sup3r_tpu/preprocessing/lazy.py``, on the pandas-free ``TimeIndex``.

``LazyGridDataset`` is the sampler-facing facade for training data that
does NOT fit host RAM: instead of one dense ``(s1, s2, t, f)`` numpy
block (``GridDataset``), it holds lazily-windowed raw variables and
derives the requested features PER SAMPLED WINDOW, reading only that
window from disk. It stands in for the reference's dask-lazy training
stores (``mode='lazy'``: reference
sup3r/preprocessing/batch_queues/abstract.py:135-141 defers compute to
sample time, samplers/base.py:228-243 computes the sampled slice).

Exactness vs the eager path: every supported derivation is pointwise
per pixel EXCEPT the wind (ws, wd) <-> (u, v) rotation, whose grid
angle at row r uses the delta between rows r and r-1 (with row 0
reusing row 1's angle — ops/wind.py). Sampling therefore reads ONE
extra halo row above the window whenever the window does not start at
the domain's first row, derives on the padded window and crops — which
makes windowed derivation bit-identical to full-domain derivation.

Features whose derivation is spatially non-local (the base-registry
``clearsky_ratio``/``cloud_mask`` night masks reduce over the whole
spatial extent) are rejected at construction; those belong to the
solar-CC handlers, which are eager by design (whole-day batching needs
the daily/hourly pairing anyway).
"""

import logging

import numpy as np

from sup3r_tpu_torch.names import Dimension
from sup3r_tpu_torch.ops.coarsen import spatial_coarsening
from sup3r_tpu_torch.preprocessing.derivers import Deriver, _Method
from sup3r_tpu_torch.preprocessing.loaders import compose_slice
from sup3r_tpu_torch.utilities.times import TimeIndex, unique_days

logger = logging.getLogger(__name__)


class _LazyH5Raster:
    """Lazy (s1, s2, t) raster view of one flattened-H5 variable: a
    window read maps the (s1, s2) window to its gid block and pulls
    only those site columns for the composed time slice (the
    gid-window equivalent of ``_LazyNCVar`` — reference laziness via
    rex/dask, sup3r/preprocessing/loaders/h5.py)."""

    dims = (Dimension.SOUTH_NORTH, Dimension.WEST_EAST, Dimension.TIME)

    def __init__(self, loader, feature, gids, time_slice):
        self._loader = loader
        self._feature = feature
        self._gids = np.asarray(gids)
        self._file_t = (len(loader.time_index)
                        if loader.time_index is not None else 1)
        self._time_slice = time_slice
        n_t = len(range(self._file_t)[time_slice])
        self.shape = (*self._gids.shape, n_t)
        self.ndim = 3
        self.dtype = np.float32

    def isel(self, sel):
        """Read a window; ``sel`` maps canonical dim name -> slice."""
        s1 = sel.get(Dimension.SOUTH_NORTH, slice(None))
        s2 = sel.get(Dimension.WEST_EAST, slice(None))
        t = sel.get(Dimension.TIME, slice(None))
        g = self._gids[s1, s2]
        tsl = compose_slice(self._time_slice, t, self._file_t)
        block = self._loader.get(self._feature, tsl, g.ravel())
        n_t = block.shape[0]
        return np.ascontiguousarray(
            block.T.reshape(*g.shape, n_t))

    def __getitem__(self, idx):
        return self.materialize()[idx]

    def __array__(self, dtype=None, copy=None):
        out = self.materialize()
        return out.astype(dtype) if dtype is not None else out

    def materialize(self):
        """Full read in canonical order."""
        return self.isel({})


#: spatially non-local derivation functions (night masks reduce over
#: the whole spatial extent) — windowed derivation would diverge from
#: the eager path, so lazy datasets reject them loudly
_NONLOCAL_FNS = ('_clearsky_ratio', '_cloud_mask')


def _parse_sample_index(idx, features, shape):
    """Normalize a sampler index tuple (s1, s2, t, f) into contiguous
    spans + the local re-application index — shared by every lazy view
    so integer squeezing, slice steps, and numpy's mixed basic/advanced
    rules come from numpy itself (see _LazySampleMixin.sample).

    Returns (spans, local, feats, f_local, two_step)."""
    s1, s2, t, f = idx
    two_step = (isinstance(f, (list, tuple)) and f
                and isinstance(f[0], str))
    if two_step:
        # eager: data[s1, s2, t][..., positions] — two separate
        # indexing ops, so name lists never join the advanced-
        # index broadcast; derive in the requested order
        feats = [x.lower() for x in f]
        f_local = slice(None)
    elif isinstance(f, slice):
        feats = features[f]
        f_local = slice(None)
    elif np.ndim(f) == 0:
        feats = [features[int(f)]]
        f_local = 0
    else:
        pos = [int(i) for i in np.atleast_1d(f)]
        feats, remap = [], []
        for i in pos:
            name = features[i]
            if name not in feats:
                feats.append(name)
            remap.append(feats.index(name))
        f_local = np.asarray(remap)
    spans, local = [], []
    for ax, ix in enumerate((s1, s2, t)):
        n = shape[ax]
        if isinstance(ix, slice):
            start, stop, step = ix.indices(n)
            if step < 0:
                raise NotImplementedError(
                    'negative-step slices are unsupported in lazy '
                    'sampling (wind rotation depends on row order) — '
                    "use mode='eager'")
            spans.append(slice(start, max(stop, start)))
            local.append(slice(None, None, step))
        else:
            i = int(ix)
            i += n if i < 0 else 0
            spans.append(slice(i, i + 1))
            local.append(0)
    return spans, local, feats, f_local, two_step


class _LazySampleMixin:
    """Shared sampler-facing behavior for lazy views: ``sample`` /
    ``normalize`` / streamed ``feature_nanstats`` expressed through the
    view's ``_derive_window(s1, s2, t, features)`` and ``shape`` /
    ``features`` / ``lat_lon`` attributes."""

    def sample(self, idx):
        """Crop by an index tuple (s1, s2, t, feature_list_or_slice)
        — the sampler hot path. Reads only the sampled window from
        disk and derives/reduces on it.

        Matches ``GridDataset``'s plain-numpy indexing semantics
        exactly: the window is derived on the CONTIGUOUS span, then
        the caller's ORIGINAL index expression is re-applied locally —
        so integer squeezing, slice steps, and numpy's mixed
        basic/advanced rules (an integer axis combined with an integer
        -array feature index moves the broadcast axis to the front,
        as ``data[s1, s2, t, f]`` does) all come from numpy itself.
        Deriving on the contiguous span matters: wind rotation's row
        angle uses adjacent rows, so deriving on strided rows directly
        would diverge from eager. Negative steps are rejected (row
        order matters to the rotation)."""
        spans, local, feats, f_local, two_step = _parse_sample_index(
            idx, self.features, self.shape)
        block = self._derive_window(*spans, feats)
        block = self._normalize_block(block, feats)
        if two_step:
            return block[tuple(local)]
        return block[(*local, f_local)]

    def _normalize_block(self, block, feats):
        """Apply recorded per-feature stats to a derived block."""
        if self._means is None:
            return block
        mean = np.array([self._means.get(x, 0.0) for x in feats],
                        dtype=np.float32)
        std = np.array([self._stds.get(x, 1.0) or 1.0
                        for x in feats], dtype=np.float32)
        return (block - mean) / std

    def normalize(self, means, stds):
        """Record per-feature stats; applied to every sampled window
        (the eager path normalizes its block in place once — same
        elementwise float32 op, so samples stay bit-identical)."""
        merged = dict(self._means or {})
        merged.update({k.lower(): float(v) for k, v in means.items()})
        self._means = merged
        merged_s = dict(self._stds or {})
        merged_s.update({k.lower(): float(v) for k, v in stds.items()})
        self._stds = merged_s

    def feature_nanstats(self, feature):
        """(nanmean, nanvar) of one derived feature, streamed over
        full-spatial time blocks (never materializes the feature).
        Used by StatsCollection in place of ``np.nanmean(m[feature])``.
        """
        feature = str(feature).lower()
        if feature in self._stats_cache:
            return self._stats_cache[feature]
        s1, s2, n_t, _ = self.shape
        block_t = max(1, self._stats_block_elems // max(s1 * s2, 1))
        count = 0
        total = 0.0
        total_sq = 0.0
        # shifted accumulation: sum (x - shift) and (x - shift)^2 with
        # shift = the first block's mean, so the closing
        # E[d^2] - E[d]^2 subtracts numbers of the VARIANCE's scale.
        # A raw one-pass E[x^2] - mean^2 cancels catastrophically for
        # large-mean/small-variance features (~15% of the variance
        # gone at mean~1e5, std~0.01 even in float64 accumulators).
        shift = None
        for t0 in range(0, n_t, block_t):
            block = self._derive_window(
                slice(0, s1), slice(0, s2),
                slice(t0, min(t0 + block_t, n_t)), [feature])
            arr = block[..., 0].astype(np.float64)
            if shift is None:
                m = np.nanmean(arr)
                shift = float(m) if np.isfinite(m) else 0.0
            d = arr - shift
            finite = np.isfinite(d)
            count += int(finite.sum())
            total += float(np.nansum(d))
            total_sq += float(np.nansum(d * d))
        if count == 0:
            stats = (float('nan'), float('nan'))
        else:
            dmean = total / count
            stats = (shift + dmean,
                     max(total_sq / count - dmean * dmean, 0.0))
        self._stats_cache[feature] = stats
        return stats

    @property
    def grid_shape(self):
        """(s1, s2)"""
        return self.lat_lon.shape[:2]

    @property
    def size(self):
        return int(np.prod(self.shape))

    def __contains__(self, feature):
        return str(feature).lower() in self.features

    def __repr__(self):
        return (f'{type(self).__name__}(shape={self.shape}, '
                f'features={self.features})')


class LazyGridDataset(_LazySampleMixin):
    """Sampler-compatible dataset that derives features per sampled
    window, reading only that window from disk.

    Exposes the subset of the ``GridDataset`` API the training stack
    touches: ``shape``/``grid_shape``/``size``/``features``/
    ``lat_lon``/``time_index``/``sample(idx)``/``normalize``, plus
    streaming ``feature_nanstats`` for ``StatsCollection``.
    """

    def __init__(self, raw, features, FeatureRegistry=None,
                 interp_kwargs=None, nan_method_kwargs=None,
                 time_shift=None, stats_block_elems=2 ** 22):
        """``raw``: full-extent RawDataset whose variables are lazy
        (``_LazyWindow``/``_LazyNCVar``/``_LazyH5Raster``).
        ``nan_method_kwargs``: only ``{'method': 'nearest'}`` is
        supported and fills NaNs PER WINDOW (window-local semantics —
        documented difference from the eager full-domain fill; reject
        NaN-bearing data if bit-parity with eager mode matters)."""
        self.raw = raw
        self.features = [f.lower() for f in features]
        self.registry = FeatureRegistry
        self.interp_kwargs = interp_kwargs or {}
        nan_kwargs = nan_method_kwargs or None
        if nan_kwargs and nan_kwargs.get('method', 'nearest') != 'nearest':
            raise NotImplementedError(
                "lazy datasets support only nan_method_kwargs={'method':"
                " 'nearest'} (window-local fill); method "
                f"'{nan_kwargs.get('method')}' needs the full domain — "
                "use mode='eager'")
        self.nan_method_kwargs = nan_kwargs
        self.lat_lon = raw.lat_lon
        ti = raw.time_index
        if time_shift is not None and ti is not None:
            ti = ti.shift(time_shift, freq='min')
        self.time_index = ti
        self.attrs = dict(raw.attrs or {})
        self.levels = raw.levels
        self._means = None
        self._stds = None
        self._stats_cache = {}
        self._stats_block_elems = int(stats_block_elems)
        self._time_shift = time_shift
        self._check_local(self.features)

    def time_slice_view(self, t_slice):
        """A new LazyGridDataset over a contiguous positional time
        crop (the daily handlers' whole-day trim): raw windows compose,
        so nothing is read. Recorded normalization stats do NOT carry
        over (views are made before stats collection)."""
        return LazyGridDataset(
            self.raw.isel(t=t_slice), self.features,
            FeatureRegistry=self.registry,
            interp_kwargs=self.interp_kwargs,
            nan_method_kwargs=self.nan_method_kwargs,
            time_shift=self._time_shift,
            stats_block_elems=self._stats_block_elems)

    # ------------------------------------------------------------------
    def _check_local(self, features):
        """Reject features whose derivation closure is spatially
        non-local (full-extent reductions can't be windowed)."""
        registry = self.registry or Deriver.FEATURE_REGISTRY
        probe = Deriver.__new__(Deriver)
        probe.FEATURE_REGISTRY = registry
        seen, stack = set(), [f.lower() for f in features]
        while stack:
            f = stack.pop()
            if f in seen or f in self.raw:
                continue
            seen.add(f)
            method = probe._check_registry(f)
            if isinstance(method, str):
                stack.append(Deriver._map_new_name(f, method))
                continue
            if isinstance(method, _Method):
                if method.fn.__name__ in _NONLOCAL_FNS:
                    raise NotImplementedError(
                        f'Feature "{f}" derives through the spatially '
                        'non-local night mask (full-extent reduction); '
                        "it cannot be windowed — use mode='eager'")
                stack.extend(probe._get_inputs(f, method))

    # ------------------------------------------------------------------
    @property
    def shape(self):
        """(s1, s2, t, f)"""
        t = 0 if self.time_index is None else len(self.time_index)
        return (*self.lat_lon.shape[:2], t, len(self.features))

    # ------------------------------------------------------------------
    def _derive_window(self, s1, s2, t, features):
        """Derive ``features`` on the (s1, s2, t) window, with the
        1-row top halo that makes wind-rotation windows bit-exact."""
        start1, stop1, _ = s1.indices(self.shape[0])
        halo = 1 if start1 > 0 else 0
        # a height-1 window at row 0 would hand _grid_angle a single
        # row (the roll delta wraps onto itself -> wrong angle);
        # extend one row BELOW and crop it after, which reproduces the
        # full-domain row-0 angle (row 0 reuses the row-0/row-1 delta)
        halo_bot = 1 if (halo == 0 and stop1 - start1 == 1
                         and stop1 < self.shape[0]) else 0
        win = self.raw.isel(s1=slice(start1 - halo, stop1 + halo_bot),
                            s2=s2, t=t)
        if self.raw.time_index is not None:
            # the deriver must see the RAW file timestamps, never the
            # time_shift-ed labels: the eager path derives first and
            # shifts only the label index afterwards
            # (derivers.py:312-314), so time-DEPENDENT derivations
            # (sza) anchor to the file clock. Handing the shifted
            # index here moved sza by time_shift (~5.8 deg at -30 min)
            tsl = t if isinstance(t, slice) else slice(t, t + 1)
            win.time_index = self.raw.time_index[tsl]
        der = Deriver(win, features,
                      nan_method_kwargs=self.nan_method_kwargs,
                      FeatureRegistry=self.registry,
                      interp_kwargs=self.interp_kwargs)
        block = der.data.data
        if halo:
            block = block[1:]
        if halo_bot:
            block = block[:-1]
        return block


class LazyDailyDataset(_LazySampleMixin):
    """Daily-coarsened view over a whole-day-trimmed lazy hourly
    dataset — the streaming counterpart of ``DailyDataHandler``'s
    eager daily member (reference: data_handlers/base.py:293-380).

    A daily window reads the corresponding hourly span through the
    hourly view's ``_derive_window`` (raw, UNNORMALIZED — daily
    reduction happens before normalization, like the eager hook
    running before StatsCollection) and reduces each feature per day:
    ``_max_``/``_min_``/``total_`` by name, mean otherwise. With
    ``csr_from_totals`` the daily ``clearsky_ratio`` is the ratio of
    the daily-mean ghi to the daily-mean clearsky_ghi (reference
    H5SolarCC semantics, data_handlers/base.py:341) — identical to
    the totals ratio, and bit-identical to the eager hook.
    """

    def __init__(self, hourly, day_steps, csr_from_totals=False,
                 stats_block_elems=2 ** 22):
        self.hourly = hourly
        self.day_steps = int(day_steps)
        n_t = hourly.shape[2]
        if n_t == 0 or n_t % self.day_steps:
            raise ValueError(
                f'LazyDailyDataset needs whole days: {n_t} hourly '
                f'steps is not a multiple of day_steps='
                f'{self.day_steps}')
        self.features = list(hourly.features)
        self.lat_lon = hourly.lat_lon
        self.time_index = TimeIndex(
            unique_days(hourly.time_index).astype('datetime64[ns]'))
        assert len(self.time_index) == n_t // self.day_steps
        self.csr_from_totals = bool(csr_from_totals)
        self._means = None
        self._stds = None
        self._stats_cache = {}
        self._stats_block_elems = int(stats_block_elems)

    @property
    def shape(self):
        """(s1, s2, n_days, f)"""
        return (*self.lat_lon.shape[:2], len(self.time_index),
                len(self.features))

    @staticmethod
    def _eager_layout(chan):
        """Relayout a (s1, s2, day_steps) block the way the eager
        hook's ``chan[:, :, day_ids == d]`` boolean indexing does
        (numpy moves the advanced-index subspace to the buffer-OUTER
        position): float32 mean/sum order follows the buffer layout,
        so matching it makes the daily reductions bit-identical."""
        return np.moveaxis(
            np.ascontiguousarray(np.moveaxis(chan, 2, 0)), 0, 2)

    @classmethod
    def _reduce_day(cls, name, chan):
        """One feature's (s1, s2, day_steps) hourly block -> (s1, s2)
        daily value, by the reference's name rules
        (data_handlers/base.py:360-374)."""
        chan = cls._eager_layout(chan)
        if '_max_' in name:
            return chan.max(axis=2)
        if '_min_' in name:
            return chan.min(axis=2)
        if 'total_' in name:
            return chan.sum(axis=2)
        return chan.mean(axis=2)

    def _derive_window(self, s1, s2, d, features):
        """(s1, s2, day-slice) daily window: read the hourly span and
        reduce per day. ``features`` may include names outside
        ``self.features`` (helper reads)."""
        d0, d1, _ = d.indices(self.shape[2])
        t = slice(d0 * self.day_steps, d1 * self.day_steps)
        feats = [f.lower() for f in features]
        csr = ('clearsky_ratio' if (self.csr_from_totals
                                    and 'clearsky_ratio' in feats)
               else None)
        hourly_feats = [f for f in feats if f != csr]
        need = list(dict.fromkeys(
            hourly_feats + (['ghi', 'clearsky_ghi'] if csr else [])))
        block = self.hourly._derive_window(s1, s2, t, need)
        n_days = d1 - d0
        # contiguous per-feature channels: reductions must run over a
        # last-axis-contiguous layout to match the eager hook's
        # float32 pairwise summation order (eager reduces an advanced-
        # indexing COPY; a stride-f view sums in a different order and
        # drifts by ~1 ulp)
        chans = {f: np.ascontiguousarray(block[..., i])
                 for i, f in enumerate(need)}
        out = np.empty((*block.shape[:2], n_days, len(feats)),
                       dtype=np.float32)
        for di in range(n_days):
            day = slice(di * self.day_steps, (di + 1) * self.day_steps)
            for j, f in enumerate(feats):
                if f == csr:
                    ghi = self._eager_layout(
                        chans['ghi'][:, :, day]).mean(axis=2)
                    cs = self._eager_layout(
                        chans['clearsky_ghi'][:, :, day]).mean(axis=2)
                    with np.errstate(divide='ignore',
                                     invalid='ignore'):
                        out[:, :, di, j] = np.where(
                            cs > 0, ghi / cs, np.nan)
                else:
                    out[:, :, di, j] = self._reduce_day(
                        f, chans[f][:, :, day])
        return out

    def coarsen(self, s_enhance):
        """Spatially block-mean-coarsened view of this daily dataset
        (the lazy form of DualSamplerCC's LR coarsening)."""
        return LazyCoarseDailyView(self, s_enhance)


class LazyCoarseDailyView(_LazySampleMixin):
    """Block-mean spatial coarsening of a lazy daily view, computed
    per sampled window. The base view's NORMALIZED values are
    coarsened (eager order: StatsCollection normalizes the daily
    member in place BEFORE DualSamplerCC coarsens it, samplers.py) —
    coarsening disjoint blocks windows cleanly, so samples are
    bit-identical to coarsening the full normalized daily array."""

    def __init__(self, base, s_enhance):
        self.base = base
        self.s_enhance = int(s_enhance)
        if any(n % self.s_enhance for n in base.lat_lon.shape[:2]):
            raise ValueError(
                f'grid {base.lat_lon.shape[:2]} not divisible by '
                f's_enhance={s_enhance}')
        self.features = list(base.features)
        self.lat_lon = spatial_coarsening(
            base.lat_lon, s_enhance=self.s_enhance, obs_axis=False)
        self.time_index = base.time_index
        self._stats_cache = {}
        self._stats_block_elems = base._stats_block_elems

    @property
    def shape(self):
        return (*self.lat_lon.shape[:2], len(self.time_index),
                len(self.features))

    # the base view owns the normalization record; this view coarsens
    # already-normalized blocks, so it must not re-apply stats
    @property
    def _means(self):
        return None

    def normalize(self, means, stds):
        self.base.normalize(means, stds)

    def _derive_window(self, s1, s2, d, features):
        se = self.s_enhance
        block = self.base._derive_window(
            slice(s1.start * se, s1.stop * se),
            slice(s2.start * se, s2.stop * se), d, features)
        block = self.base._normalize_block(
            block, [f.lower() for f in features])
        return np.asarray(spatial_coarsening(
            block, s_enhance=se, obs_axis=False), dtype=np.float32)


class _LazyClearskyGHI:
    """Lazy (s1, s2, t) clearsky_ghi variable for GCM handlers: window
    reads are pure array indexing into a PRECOMPUTED per-pixel NSRDB
    daily table (built once per handler — see
    DataHandlerNCforCC._clearsky_daily_table; rebuilding the regrid
    per window cost an NSRDB open + full-site KDTree + whole-year
    daily means in the sampler hot path) plus the precomputed
    per-pixel full-time-extent scale raster (reference
    nc_cc.py:231-240 scales per pixel over the FULL time axis, so
    windowed reads must use the full-extent factors — the same
    invariant as chunked_io). Bit-identical to the eager injection:
    the table rows are the same daily means and the scale is an
    elementwise multiply."""

    dims = (Dimension.SOUTH_NORTH, Dimension.WEST_EAST, Dimension.TIME)

    def __init__(self, table, rows, scale):
        self._table = np.asarray(table)  # (n_days, s1, s2)
        self._rows = np.asarray(rows)    # (n_t,) table row per step
        self._scale = scale  # (s1, s2) raster, scalar, or None
        self.shape = (*self._table.shape[1:], len(self._rows))
        self.ndim = 3
        self.dtype = np.float32

    def isel(self, sel):
        s1 = sel.get(Dimension.SOUTH_NORTH, slice(None))
        s2 = sel.get(Dimension.WEST_EAST, slice(None))
        t = sel.get(Dimension.TIME, slice(None))
        cs = self._table[:, s1, s2][self._rows[t]]  # (nt, ns1, ns2)
        cs = np.moveaxis(cs, 0, -1)
        scale = self._scale
        if isinstance(scale, np.ndarray) and scale.ndim == 2:
            cs = cs * scale[s1, s2][:, :, None]
        elif scale is not None:
            cs = cs * scale
        return np.ascontiguousarray(cs, dtype=np.float32)

    def __getitem__(self, idx):
        return self.materialize()[idx]

    def __array__(self, dtype=None, copy=None):
        out = self.materialize()
        return out.astype(dtype) if dtype is not None else out

    def materialize(self):
        """Full read in canonical order."""
        return self.isel({})
