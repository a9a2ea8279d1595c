"""PresRat bias calibration: QDM + zero-precipitation-rate preservation
+ K-factor mean-trend preservation [Pierce2015].

The port's copy of ``sup3r_tpu/bias/presrat.py``. Reference parity:
sup3r/bias/presrat.py:33-494, mixins.py:105 (ZeroRateMixin).
"""

import logging
import warnings

import numpy as np
import torch

from sup3r_tpu_torch.bias.base import _run_gid_loop
from sup3r_tpu_torch.bias.qdm import QuantileDeltaMappingCorrection
from sup3r_tpu_torch.bias.qdm_math import (
    QuantileDeltaMapping,
    qdm_transform_device,
    sampled_quantiles,
)

logger = logging.getLogger(__name__)


def zero_precipitation_rate(arr, threshold=0.0):
    """Fraction of finite values at or below ``threshold`` (the
    reference code's semantics, mixins.py:160 ``arr <= threshold``; its
    docstring example disagrees with its own code, and the code wins)."""
    finite = np.asarray(arr)[np.isfinite(arr)]
    if finite.size == 0:
        return np.nan
    return float((finite <= threshold).sum() / finite.size)


class PresRat(QuantileDeltaMappingCorrection):
    """QDM + tau (dry-day preservation) + K factors."""

    def __init__(self, *args, zero_rate_threshold=1.157e-7, **kwargs):
        super().__init__(*args, **kwargs)
        self.zero_rate_threshold = zero_rate_threshold

    @classmethod
    def calc_tau_fut(cls, base_data, bias_data, bias_fut_data,
                     corrected_fut_data, zero_rate_threshold=1.157e-7):
        """Threshold preserving the model-predicted dry-day fraction
        (reference: presrat.py:96)."""
        obs_zero_rate = zero_precipitation_rate(base_data,
                                                zero_rate_threshold)
        n_threshold = round(obs_zero_rate * bias_data.size)
        n_threshold = min(n_threshold, bias_data.size - 1)
        tau = np.sort(bias_data)[n_threshold]
        z_fg = float((bias_fut_data < tau).sum() / bias_fut_data.size)
        idx = min(round(z_fg * corrected_fut_data.size),
                  corrected_fut_data.size - 1)
        tau_fut = np.sort(corrected_fut_data)[idx]
        return tau_fut, obs_zero_rate

    def calc_k_factor(self, base_data, bias_data, bias_fut_data,
                      corrected_fut_data, base_ti, bias_ti,
                      bias_fut_ti):
        """Per-window K preserving the model's mean change:
        K = (<mf>/<mh>) / (<qdm(mf)>/<oh>) (reference:
        presrat.py:253, Pierce 2015 eq. 7)."""
        k = np.full(self.n_time_steps, np.nan, np.float32)
        masks = zip(self._window_masks(base_ti),
                    self._window_masks(bias_ti),
                    self._window_masks(bias_fut_ti))
        for nt, (base_idx, bias_idx, fut_idx) in enumerate(masks):
            if not (base_idx.any() and bias_idx.any()
                    and fut_idx.any()):
                continue
            thr = self.zero_rate_threshold
            mean_oh = max(np.nanmean(base_data[base_idx]), thr)
            mean_mh = max(np.nanmean(bias_data[bias_idx]), thr)
            mean_mf = max(np.nanmean(bias_fut_data[fut_idx]), thr)
            mean_corr = max(np.nanmean(corrected_fut_data[fut_idx]),
                            thr)
            # clamping every mean to >= zero_rate_threshold bounds K
            # in arid regions (reference: presrat.py:241-244)
            denom = mean_corr * mean_mh
            if denom and np.isfinite(denom):
                k[nt] = (mean_mf * mean_oh) / denom
        return k

    def _init_out(self):
        out = super()._init_out()
        shape2 = (*self.bias_gid_raster.shape, 1)
        out[f'{self.bias_feature}_tau_fut'] = np.full(shape2, np.nan,
                                                      np.float32)
        out[f'{self.bias_feature}_k_factor'] = np.full(
            (*self.bias_gid_raster.shape, self.n_time_steps), np.nan,
            np.float32)
        # the reference schema keys the zero rate by the BASE dset
        # (presrat.py:84: out[f'{base_dset}_zero_rate'])
        out[f'{self.base_dset}_zero_rate'] = np.full(shape2, np.nan,
                                                     np.float32)
        return out

    # ------------------------------------------------------------------
    # batched all-gid path
    def _feature_raster(self, dh):
        """(s1, s2, T) float32 feature raster with decimals rounding
        (same preprocessing as the per-gid ``get_bias_data``)."""
        arr = np.asarray(dh.data[self.bias_feature], dtype=np.float32)
        if self.decimals is not None:
            arr = np.round(arr, self.decimals)
        return arr

    def _correct_fut_raster(self, bias_params, fut_params, base_params,
                            fut_arr, fut_ti, window_ok=None,
                            use_device=False):
        """Windowed relative QDM of the future raster for ALL gids at
        once: (s1, s2, Tf). Window-by-window application keeps the
        per-gid path's later-window-overwrites semantics for
        overlapping custom window sizes. ``window_ok`` marks windows
        where base AND bias AND fut all have samples; the others stay
        NaN exactly like the per-gid ``_correct_fut`` guard.

        The device path pads every window to one length (the
        ``_window_index_matrix`` pattern) and corrects every (gid,
        window) column in one batched ``qdm_transform_device`` on
        ``self.device``."""
        s1, s2, _ = fut_arr.shape
        nq = self.n_quantiles
        nt_all = self.n_time_steps
        corrected = np.full(fut_arr.shape, np.nan, np.float32)
        quantiles = sampled_quantiles(nq, self.sampling, self.log_base)
        if window_ok is None:
            window_ok = np.ones(nt_all, dtype=bool)
        if use_device:
            dev = self.device
            idx, valid = self._window_index_matrix(fut_ti)
            # (s1, s2, NT, L) -> columns (s1*s2*NT, L) with per-column
            # params: gid-major, window-minor, which is the (s1, s2,
            # NT, NQ) rasters' own C order
            vals = torch.as_tensor(fut_arr, device=dev)[
                :, :, torch.as_tensor(idx, device=dev)].reshape(
                s1 * s2 * nt_all, -1)

            def cols(p):
                return torch.as_tensor(
                    p.reshape(s1 * s2 * nt_all, nq), device=dev)

            res = qdm_transform_device(
                vals, cols(base_params), cols(bias_params),
                cols(fut_params), quantiles.astype(np.float32),
                relative=self.relative,
                delta_denom_min=self.zero_rate_threshold)
            res = res.reshape(s1, s2, nt_all, -1).cpu().numpy()
            for nt in range(nt_all):
                if not window_ok[nt]:
                    continue
                w = idx[nt][valid[nt]]
                if len(w):
                    corrected[:, :, w] = res[:, :, nt, :len(w)]
            return corrected
        for nt, fut_idx in enumerate(self._window_masks(fut_ti)):
            if not window_ok[nt] or not fut_idx.any():
                continue
            oh = base_params[:, :, nt, :].reshape(-1, nq)
            mh = bias_params[:, :, nt, :].reshape(-1, nq)
            mf = fut_params[:, :, nt, :].reshape(-1, nq)
            data = fut_arr[:, :, fut_idx].reshape(s1 * s2, -1)
            qdm = QuantileDeltaMapping(
                oh, mh, mf, relative=self.relative,
                sampling=self.sampling, log_base=self.log_base,
                delta_denom_min=self.zero_rate_threshold)
            res = qdm(data.T).T
            corrected[:, :, fut_idx] = res.reshape(s1, s2, -1)
        return corrected

    @staticmethod
    def _tau_fut_raster(bias_arr, fut_arr, corrected, zero_rate):
        """Vectorized ``calc_tau_fut`` over all gids: per-gid dry-day
        thresholds from sorted series (reference: presrat.py:96)."""
        _, _, tb = bias_arr.shape
        valid_gid = np.isfinite(zero_rate)
        zr = np.where(valid_gid, zero_rate, 0.0)
        nth = np.minimum(np.round(zr * tb), tb - 1).astype(np.int64)
        tau = np.take_along_axis(np.sort(bias_arr, axis=-1),
                                 nth[..., None], axis=-1)[..., 0]
        valid = np.isfinite(corrected)
        n_valid = valid.sum(axis=-1)
        cnt = ((fut_arr < tau[..., None]) & valid).sum(axis=-1)
        with np.errstate(divide='ignore', invalid='ignore'):
            z_fg = cnt / n_valid
        idx = np.minimum(np.round(np.where(n_valid > 0, z_fg, 0)
                                  * n_valid),
                         np.maximum(n_valid - 1, 0)).astype(np.int64)
        # NaNs sort last, so the first n_valid entries are the finite
        # corrected values the per-gid path sorted
        sc = np.sort(corrected, axis=-1)
        tau_fut = np.take_along_axis(sc, idx[..., None],
                                     axis=-1)[..., 0]
        bad = ~valid_gid | (n_valid == 0)
        return np.where(bad, np.nan, tau_fut).astype(np.float32)

    def _k_factor_raster(self, bias_arr, fut_arr, corrected, mean_oh,
                         bias_ti, fut_ti):
        """Vectorized ``calc_k_factor``: K = (<mf>/<mh>) / (<qdm(mf)>
        /<oh>) per window per gid (reference: presrat.py:253)."""
        s1, s2 = bias_arr.shape[:2]
        k = np.full((s1, s2, self.n_time_steps), np.nan, np.float32)
        masks = zip(self._window_masks(bias_ti),
                    self._window_masks(fut_ti))
        for nt, (bias_idx, fut_idx) in enumerate(masks):
            if not (bias_idx.any() and fut_idx.any()):
                continue
            # float32 accumulation on purpose: matches the per-gid
            # scalar math (base/bias series are float32) bit-for-bit
            thr = np.float32(self.zero_rate_threshold)
            with warnings.catch_warnings():
                warnings.simplefilter('ignore', RuntimeWarning)
                mean_mh = np.maximum(
                    np.nanmean(bias_arr[:, :, bias_idx], axis=-1), thr)
                mean_mf = np.maximum(
                    np.nanmean(fut_arr[:, :, fut_idx], axis=-1), thr)
                mean_corr = np.maximum(
                    np.nanmean(corrected[:, :, fut_idx], axis=-1), thr)
            moh = np.maximum(mean_oh[:, :, nt], thr)
            denom = mean_corr * mean_mh
            with np.errstate(divide='ignore', invalid='ignore'):
                kk = (mean_mf * moh) / denom
            ok = np.isfinite(denom) & (denom != 0) & np.isfinite(kk)
            k[:, :, nt] = np.where(ok, kk, np.nan).astype(np.float32)
        return k

    def run(self, fp_out=None, max_workers=1, daily_reduction='avg',
            fill_extend=True, smooth_extend=0, smooth_interior=0,
            use_device=None):
        """Compute QDM params + tau/zero-rate/K rasters for every gid.

        All-gid batched: the windowed CDFs, the QDM correction of the
        future series, and the tau/K statistics are vectorized over
        the full raster (``use_device=True`` runs the percentiles and
        the QDM transform in torch on ``self.device``). Only the
        per-gid baseline retrieval (irregular neighbor aggregation, the
        daily reduction) and its zero rate run in the threaded gid loop.
        Replaces the reference's per-gid ProcessPoolExecutor (reference:
        sup3r/bias/bias_calc.py:191-255, presrat.py:96-253)."""
        use_device = self._resolve_use_device(use_device)
        out = self._init_out()
        shape = self.bias_gid_raster.shape
        zero_rate = np.full(shape, np.nan, np.float32)
        mean_oh = np.full((*shape, self.n_time_steps), np.nan,
                          np.float32)
        base_key = f'base_{self.base_dset}_params'
        bias_key = f'bias_{self.bias_feature}_params'
        fut_key = f'bias_fut_{self.bias_feature}_params'
        valid_gids = np.zeros(self.bias_gid_raster.size, dtype=bool)

        def one_gid(bias_gid):
            base_data, base_ti = self.get_base_data(
                bias_gid, daily_reduction=daily_reduction)
            if base_data is None:
                return bias_gid, None, None, None
            return bias_gid, base_data, base_ti, zero_precipitation_rate(
                base_data, self.zero_rate_threshold)

        gids, series, base_ti, extras = self._base_rows(_run_gid_loop(
            one_gid, self.bias_gid_raster.size, max_workers))
        if series is not None:
            valid_gids[gids] = True
            rows, cols = np.unravel_index(gids, shape)
            out[base_key][rows, cols] = self._window_percentiles(
                series, base_ti, use_device)[:, 0]
            zero_rate[rows, cols] = [zr for zr, in extras]
            for nt, mask in enumerate(self._window_masks(base_ti)):
                if mask.any():
                    mean_oh[rows, cols, nt] = np.nanmean(
                        series[:, 0, mask], axis=-1)

        bias_ti = self.bias_time_index
        fut_ti = self.bias_fut_dh.time_index
        bias_arr = self._feature_raster(self.bias_dh)
        fut_arr = self._feature_raster(self.bias_fut_dh)
        out[bias_key] = self._windowed_params_raster(
            bias_arr, bias_ti, use_device=use_device)
        out[fut_key] = self._windowed_params_raster(
            fut_arr, fut_ti, use_device=use_device)

        # per-gid `_correct_fut` guard: a window only corrects when
        # base AND bias AND fut all have samples in it
        window_ok = np.ones(self.n_time_steps, dtype=bool)
        if base_ti is not None:
            window_ok = self._window_ok(base_ti, bias_ti, fut_ti)
        corrected = self._correct_fut_raster(
            out[bias_key], out[fut_key], out[base_key], fut_arr,
            fut_ti, window_ok=window_ok, use_device=use_device)
        invalid = ~valid_gids.reshape(shape)
        corrected[invalid] = np.nan

        out[f'{self.bias_feature}_tau_fut'][..., 0] = \
            self._tau_fut_raster(bias_arr, fut_arr, corrected,
                                 zero_rate)
        out[f'{self.bias_feature}_k_factor'][:] = self._k_factor_raster(
            bias_arr, fut_arr, corrected, mean_oh, bias_ti, fut_ti)
        out[f'{self.base_dset}_zero_rate'][..., 0] = zero_rate

        # a window's params only exist when base AND bias AND fut all
        # have samples in it
        for key in (base_key, bias_key, fut_key):
            out[key][:, :, ~window_ok, :] = np.nan
        out[bias_key][invalid] = np.nan
        out[fut_key][invalid] = np.nan

        flat = {k: v.reshape(*v.shape[:2], -1) for k, v in out.items()}
        flat = self.fill_and_smooth(flat, fill_extend, smooth_extend,
                                    smooth_interior)
        for k in out:
            out[k] = flat[k].reshape(out[k].shape)
        if fp_out is not None:
            self.write_outputs(fp_out, out)
        return out

    def factor_cfg(self, extra_attrs=None):
        """The QDM 'cfg' plus the zero-rate threshold, which the
        runtime transform takes as its default ``delta_denom_min``."""
        attrs = {'zero_rate_threshold': self.zero_rate_threshold}
        attrs.update(extra_attrs or {})
        return super().factor_cfg(attrs)
