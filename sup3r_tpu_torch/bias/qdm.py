"""Quantile Delta Mapping factor calculation: windowed empirical CDFs
for observed-historical / modeled-historical / modeled-future data.

The port's copy of ``sup3r_tpu/bias/qdm.py``. Reference parity:
sup3r/bias/qdm.py:50-583. The all-gid windowed percentiles run on a
torch device (``device``, the card by default) or on the host in numpy;
the per-gid baseline retrieval runs in a threaded gid loop on the host.
"""

import logging

import numpy as np
import torch

from sup3r_tpu_torch.bias.base import DataRetrievalBase, _run_gid_loop
from sup3r_tpu_torch.bias.bias_calc import (
    FillAndSmoothMixin,
    LinearCorrection,
)
from sup3r_tpu_torch.bias.qdm_math import sampled_quantiles
from sup3r_tpu_torch.bias.transforms import window_mask
from sup3r_tpu_torch.preprocessing.data_handlers import (
    get_input_handler_class,
)
from sup3r_tpu_torch.utilities import resolve_device

logger = logging.getLogger(__name__)

#: most elements one ``torch.nanquantile`` call takes: torch refuses
#: inputs past 2 ** 24 ("quantile() input tensor is too large"), so the
#: padded window tensor is split over its (gid, window) rows below this
NANQUANTILE_MAX_ELEMENTS = 2 ** 24


def window_center(ntimes):
    """ntimes equally spaced days-of-year, shifted half an interval
    (reference: qdm.py:273)."""
    assert ntimes > 0
    dt = 365 / ntimes
    return np.arange(dt / 2, 366, dt)


def nanquantile_rows(vals, q):
    """``torch.nanquantile(vals, q, dim=-1)`` of a (rows, L) tensor, in
    row blocks of at most ``NANQUANTILE_MAX_ELEMENTS`` elements; returns
    (len(q), rows)."""
    rows, length = vals.shape
    if length > NANQUANTILE_MAX_ELEMENTS:
        raise ValueError(f'A window of {length} samples is longer than '
                         'torch.nanquantile takes')
    step = max(1, NANQUANTILE_MAX_ELEMENTS // max(length, 1))
    return torch.cat([torch.nanquantile(vals[r:r + step], q, dim=-1,
                                        interpolation='linear')
                      for r in range(0, rows, step)], dim=1)


class QuantileDeltaMappingCorrection(FillAndSmoothMixin,
                                     DataRetrievalBase):
    """Estimate empirical CDF parameter rasters for QDM.

    ``device`` places the batched percentiles (and PresRat's QDM of the
    future series) when ``run(use_device=...)`` asks for the device
    path; ``None`` is the card, which then must exist.
    ``use_device=None`` takes the device path on a card and the numpy
    host path on ``device='cpu'``."""

    def __init__(self, base_fps, bias_fps, bias_fut_fps, base_dset,
                 bias_feature, distance_upper_bound=None, target=None,
                 shape=None, base_handler='LoaderH5',
                 bias_handler='DataHandler', base_handler_kwargs=None,
                 bias_handler_kwargs=None,
                 bias_fut_handler_kwargs=None, decimals=None,
                 match_zero_rate=False, n_quantiles=101,
                 dist='empirical', relative=True, sampling='linear',
                 log_base=10, n_time_steps=24, window_size=None,
                 device=None):
        self.device = resolve_device('cuda' if device is None else device)
        super().__init__(
            base_fps, bias_fps, base_dset, bias_feature, target=target,
            shape=shape, base_handler=base_handler,
            bias_handler=bias_handler,
            base_handler_kwargs=base_handler_kwargs,
            bias_handler_kwargs=bias_handler_kwargs, decimals=decimals,
            match_zero_rate=match_zero_rate,
            distance_upper_bound=distance_upper_bound)
        HandlerClass = (get_input_handler_class(bias_handler)
                        if isinstance(bias_handler, str)
                        else bias_handler)
        self.bias_fut_dh = HandlerClass(
            bias_fut_fps, features=[bias_feature], target=target,
            shape=shape, **(bias_fut_handler_kwargs
                            or bias_handler_kwargs or {}))
        self.n_quantiles = n_quantiles
        self.dist = dist
        self.relative = relative
        self.sampling = sampling
        self.log_base = log_base
        self.n_time_steps = n_time_steps
        self.window_size = window_size or 365 / n_time_steps
        self.time_window_center = window_center(n_time_steps)

    def get_bias_fut_data(self, bias_gid):
        """(t,) future biased series for one grid cell."""
        row, col = np.unravel_index(bias_gid,
                                    self.bias_gid_raster.shape)
        out = self.bias_fut_dh.data[self.bias_feature][row, col]
        if self.decimals is not None:
            out = np.round(out, self.decimals)
        return np.asarray(out)

    def get_qdm_params(self, bias_data, bias_fut_data, base_data):
        """Empirical CDF x-values at the sampled quantiles."""
        quantiles = sampled_quantiles(self.n_quantiles, self.sampling,
                                      self.log_base) * 100
        return {
            f'base_{self.base_dset}_params': np.nanpercentile(
                base_data, quantiles),
            f'bias_{self.bias_feature}_params': np.nanpercentile(
                bias_data, quantiles),
            f'bias_fut_{self.bias_feature}_params': np.nanpercentile(
                bias_fut_data, quantiles),
        }

    def _init_out(self):
        keys = [f'base_{self.base_dset}_params',
                f'bias_{self.bias_feature}_params',
                f'bias_fut_{self.bias_feature}_params']
        shape = (*self.bias_gid_raster.shape, self.n_time_steps,
                 self.n_quantiles)
        return {k: np.full(shape, np.nan, np.float32) for k in keys}

    def _window_masks(self, ti):
        """The ``window_mask`` of each window center over ``ti``."""
        doy = ti.dayofyear
        return [window_mask(doy, d0, self.window_size)
                for d0 in self.time_window_center]

    def _window_index_matrix(self, ti):
        """(NT, L) time-index matrix + validity mask padding each
        day-of-year window to the longest window's length, so the
        device path takes every window in one batched call."""
        masks = self._window_masks(ti)
        length = max((int(m.sum()) for m in masks), default=0)
        length = max(length, 1)
        idx = np.zeros((len(masks), length), dtype=np.int64)
        valid = np.zeros((len(masks), length), dtype=bool)
        for i, m in enumerate(masks):
            w = np.flatnonzero(m)
            idx[i, :len(w)] = w
            valid[i, :len(w)] = True
        return idx, valid

    def _windowed_params_raster(self, arr, ti, use_device=False):
        """Windowed CDF params for ALL gids at once: (s1, s2, NT, NQ),
        from the float32 raster (rounded to ``decimals``) as the per-gid
        path reads it.

        Replaces the reference's per-gid ProcessPoolExecutor fan-out
        (reference: bias_calc.py:191-255) with a batched percentile
        over the full raster (``_window_percentiles``)."""
        arr = np.asarray(arr, dtype=np.float32)
        if self.decimals is not None:
            arr = np.round(arr, self.decimals)
        return self._window_percentiles(arr, ti, use_device)

    def _window_percentiles(self, arr, ti, use_device=False):
        """The sampled percentiles of every day-of-year window of every
        (s1, s2) series of ``arr`` (s1, s2, T) over the stamps ``ti``:
        (s1, s2, NT, NQ) float32, NaN where a window has no stamps.

        ``use_device=True`` pads every window to one length and takes
        one batched ``torch.nanquantile`` over the (gid, window) rows on
        ``self.device`` (split under ``NANQUANTILE_MAX_ELEMENTS``); the
        host path loops windows with numpy, which matches the per-gid
        ``np.nanpercentile`` of each window exactly (the device path
        differs at fp32 interpolation tolerance)."""
        quantiles = sampled_quantiles(self.n_quantiles, self.sampling,
                                      self.log_base) * 100
        s1, s2 = arr.shape[:2]
        out = np.full((s1, s2, self.n_time_steps, self.n_quantiles),
                      np.nan, np.float32)
        idx, valid = self._window_index_matrix(ti)
        if use_device:
            dev = self.device
            vals = torch.as_tensor(arr, device=dev)[
                :, :, torch.as_tensor(idx, device=dev)]  # (s1, s2, NT, L)
            vals = torch.where(torch.as_tensor(valid, device=dev), vals,
                               torch.full((), float('nan'), device=dev))
            q = torch.as_tensor(quantiles / 100, dtype=torch.float32,
                                device=dev).clamp(0, 1)
            res = nanquantile_rows(vals.reshape(-1, idx.shape[1]), q)
            out = res.T.reshape(s1, s2, self.n_time_steps,
                                self.n_quantiles).cpu().numpy()
            out[:, :, ~valid.any(axis=1), :] = np.nan
            return out
        for nt in range(self.n_time_steps):
            w = idx[nt][valid[nt]]
            if not len(w):
                continue
            # vectorized over every gid in one percentile call; without
            # NaNs np.percentile gives np.nanpercentile's values at a
            # fraction of its cost (which loops rows)
            vals = arr[:, :, w]
            pct = (np.nanpercentile if np.isnan(vals).any()
                   else np.percentile)
            res = pct(vals, quantiles, axis=-1)
            out[:, :, nt, :] = np.transpose(res, (1, 2, 0))
        return out

    @staticmethod
    def _base_rows(results):
        """Collect the gid loop's ``(bias_gid, base series, base time
        index, ...)`` results: the valid gids' flat indices, the base
        series stacked (n_valid, 1, T) and their shared time index, with
        each result's remaining items."""
        valid = [r for r in results if r[1] is not None]
        gids = np.array([r[0] for r in valid], dtype=np.int64)
        if not len(valid):
            return gids, None, None, []
        series = np.stack([r[1] for r in valid])[:, None, :]
        return gids, series, valid[0][2], [r[3:] for r in valid]

    def _resolve_use_device(self, use_device):
        """``use_device=None`` takes the device path on a card and the
        host path on ``device='cpu'`` (numpy float64 is both exact and
        fast there)."""
        if use_device is not None:
            return bool(use_device)
        return self.device.type != 'cpu'

    def _window_ok(self, base_ti, bias_ti, fut_ti):
        """Windows where base AND bias AND fut all have samples
        (reference semantics, qdm.py:415-430)."""
        return np.array([
            b.any() and h.any() and f.any() for b, h, f in zip(
                self._window_masks(base_ti), self._window_masks(bias_ti),
                self._window_masks(fut_ti))])

    def run(self, fp_out=None, max_workers=1, daily_reduction='avg',
            fill_extend=True, smooth_extend=0, smooth_interior=0,
            use_device=None):
        """Compute QDM parameter rasters for every gid; write to H5.

        The base / bias / bias_fut windowed CDFs are computed for all
        gids in batched percentile calls (``use_device=True`` runs them
        in torch on ``self.device``); only the retrieval of the baseline
        series (irregular per-gid neighbor aggregations and the daily
        reduction) runs in the threaded gid loop (reference:
        bias_calc.py:191-255)."""
        use_device = self._resolve_use_device(use_device)
        out = self._init_out()

        def one_gid(bias_gid):
            base_data, base_ti = self.get_base_data(
                bias_gid, daily_reduction=daily_reduction)
            return bias_gid, base_data, base_ti

        base_key = f'base_{self.base_dset}_params'
        shape = self.bias_gid_raster.shape
        valid_gids = np.zeros(self.bias_gid_raster.size, dtype=bool)
        gids, series, base_ti, _ = self._base_rows(
            _run_gid_loop(one_gid, self.bias_gid_raster.size, max_workers))
        if series is not None:
            valid_gids[gids] = True
            rows, cols = np.unravel_index(gids, shape)
            # every gid's base windows in one batched percentile
            out[base_key][rows, cols] = self._window_percentiles(
                series, base_ti, use_device)[:, 0]

        bias_key = f'bias_{self.bias_feature}_params'
        fut_key = f'bias_fut_{self.bias_feature}_params'
        out[bias_key] = self._windowed_params_raster(
            self.bias_dh.data[self.bias_feature],
            self.bias_time_index, use_device=use_device)
        out[fut_key] = self._windowed_params_raster(
            self.bias_fut_dh.data[self.bias_feature],
            self.bias_fut_dh.time_index, use_device=use_device)
        # a window's params only exist when base AND bias AND fut all
        # have samples in it
        if base_ti is not None:
            window_ok = self._window_ok(base_ti, self.bias_time_index,
                                        self.bias_fut_dh.time_index)
            for k in (base_key, bias_key, fut_key):
                out[k][:, :, ~window_ok, :] = np.nan
        # gids with no mapped baseline stay NaN everywhere (matching
        # the per-gid reference behavior) and are later filled/smoothed
        invalid = ~valid_gids.reshape(shape)
        out[bias_key][invalid] = np.nan
        out[fut_key][invalid] = np.nan
        # fill/smooth over the leading spatial dims of 4D param arrays
        flat = {k: v.reshape(*v.shape[:2], -1) for k, v in out.items()}
        flat = self.fill_and_smooth(flat, fill_extend, smooth_extend,
                                    smooth_interior)
        out = {k: v.reshape(*v.shape[:2], self.n_time_steps,
                            self.n_quantiles)
               for k, v in flat.items()}
        if fp_out is not None:
            self.write_outputs(fp_out, out)
        return out

    def factor_cfg(self, extra_attrs=None):
        """The factor file's 'cfg': the run's metadata, the QDM
        settings the runtime transform reads, and ``extra_attrs``."""
        attrs = {
            'time_window_center': self.time_window_center.tolist(),
            'sampling': self.sampling,
            'log_base': self.log_base,
            'n_quantiles': self.n_quantiles,
            'dist': self.dist,
            'relative': self.relative,
        }
        attrs.update(extra_attrs or {})
        return LinearCorrection.factor_cfg(self, attrs)

    def write_outputs(self, fp_out, out, extra_attrs=None):
        """Write parameter rasters + QDM config attrs to H5."""
        LinearCorrection.write_outputs(self, fp_out, out,
                                       extra_attrs=extra_attrs)
