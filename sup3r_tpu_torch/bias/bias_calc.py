"""Linear / scalar / monthly bias factor calculation + skill stats.

The port's copy of ``sup3r_tpu/bias/bias_calc.py``. Reference parity:
sup3r/bias/bias_calc.py:22-538 (LinearCorrection :22, ScalarCorrection
:256, monthly variants :311-377, SkillAssessment :379), mixins.py:13
(fill-and-smooth). ``write_outputs`` writes H5 through h5py;
``utilities.test_helpers.write_nc_factor_file`` writes the NetCDF3 form
of the same file where h5py is missing.
"""

import logging
import os

import numpy as np
from scipy import stats
from scipy.ndimage import gaussian_filter

from sup3r_tpu_torch.bias.base import DataRetrievalBase, _run_gid_loop
from sup3r_tpu_torch.utilities import nn_fill_array, safe_serialize

logger = logging.getLogger(__name__)


class FillAndSmoothMixin:
    """NN-fill NaN factor pixels + optional extra smoothing."""

    def fill_and_smooth(self, out, fill_extend=True, smooth_extend=0,
                        smooth_interior=0):
        """Fill missing (no base data) pixels from neighbors; smooth the
        filled extension and/or the interior (reference:
        sup3r/bias/mixins.py:19-102).

        The NN fill also runs whenever ``smooth_interior > 0`` (even
        with ``fill_extend=False``: interior smoothing must not pull
        NaNs across the boundary), and BOTH smoothed variants come from
        the same filled layer, extension pixels taking the
        ``smooth_extend`` result and interior pixels the
        ``smooth_interior`` result."""
        for key, arr in out.items():
            if arr.dtype == object or arr.ndim < 2:
                continue
            nan_mask = np.isnan(arr[..., 0])
            for idt in range(arr.shape[-1]):
                layer = arr[..., idt].copy()
                needs_fill = ((fill_extend and np.isnan(layer).any())
                              or smooth_interior > 0)
                if needs_fill:
                    layer = nn_fill_array(layer)
                ext = interior = layer
                if smooth_extend > 0:
                    ext = gaussian_filter(layer, smooth_extend,
                                          mode='nearest')
                if smooth_interior > 0:
                    interior = gaussian_filter(layer, smooth_interior,
                                               mode='nearest')
                arr[nan_mask, idt] = ext[nan_mask]
                arr[~nan_mask, idt] = interior[~nan_mask]
            out[key] = arr
        return out


class LinearCorrection(FillAndSmoothMixin, DataRetrievalBase):
    """Per-gid scalar/adder from mean/std matching: correct =
    bias * scalar + adder."""

    #: number of factor layers in the last axis (12 for monthly)
    NT = 1

    @staticmethod
    def get_linear_correction(bias_data, base_data, bias_feature,
                              base_dset):
        """scalar = std(base)/std(bias); adder = mean(base) -
        mean(bias)*scalar (reference: bias_calc.py:51)."""
        bias_std = np.nanstd(bias_data)
        if bias_std == 0:
            bias_std = np.nanstd(base_data)
        scalar = np.nanstd(base_data) / bias_std
        adder = np.nanmean(base_data) - np.nanmean(bias_data) * scalar
        return {
            f'bias_{bias_feature}_mean': np.nanmean(bias_data),
            f'bias_{bias_feature}_std': bias_std,
            f'base_{base_dset}_mean': np.nanmean(base_data),
            f'base_{base_dset}_std': np.nanstd(base_data),
            f'{bias_feature}_scalar': scalar,
            f'{bias_feature}_adder': adder,
        }

    def _init_out(self):
        keys = [f'bias_{self.bias_feature}_mean',
                f'bias_{self.bias_feature}_std',
                f'base_{self.base_dset}_mean',
                f'base_{self.base_dset}_std',
                f'{self.bias_feature}_scalar',
                f'{self.bias_feature}_adder']
        shape = (*self.bias_gid_raster.shape, self.NT)
        return {k: np.full(shape, np.nan, np.float32) for k in keys}

    def _stats_single(self, bias_data, base_data, bias_ti, base_ti):
        """Single-gid factor dict; subclasses do monthly loops."""
        out = self.get_linear_correction(
            bias_data, base_data, self.bias_feature, self.base_dset)
        return {k: np.array([v]) for k, v in out.items()}

    def run(self, fp_out=None, max_workers=1, daily_reduction='avg',
            fill_extend=True, smooth_extend=0, smooth_interior=0):
        """Compute factors for every bias gid and optionally write the
        factor file. Returns the dict of factor rasters."""
        out = self._init_out()

        def one_gid(bias_gid):
            base_data, base_ti = self.get_base_data(
                bias_gid, daily_reduction=daily_reduction)
            if base_data is None:
                return bias_gid, None
            bias_data = self.get_bias_data(bias_gid)
            if self.match_zero_rate:
                bias_data = self._match_zero_rate(bias_data, base_data)
            return bias_gid, self._stats_single(
                bias_data, base_data, self.bias_time_index, base_ti)

        for bias_gid, single in _run_gid_loop(
                one_gid, self.bias_gid_raster.size, max_workers):
            if single is None:
                continue
            row, col = np.unravel_index(bias_gid,
                                        self.bias_gid_raster.shape)
            for key, val in single.items():
                out[key][row, col, :len(val)] = val
        out = self.fill_and_smooth(out, fill_extend, smooth_extend,
                                   smooth_interior)
        if fp_out is not None:
            self.write_outputs(fp_out, out)
        return out

    def factor_cfg(self, extra_attrs=None):
        """The 'cfg' attribute of the factor file: the run's metadata
        and ``extra_attrs``."""
        cfg = dict(self.meta)
        cfg.update(extra_attrs or {})
        return cfg

    def write_outputs(self, fp_out, out, extra_attrs=None):
        """Write factor rasters + coordinates + config attrs to H5."""
        import h5py

        os.makedirs(os.path.dirname(os.path.abspath(fp_out)),
                    exist_ok=True)
        with h5py.File(fp_out, 'w') as f:
            lat_lon = self.bias_dh.lat_lon
            f.create_dataset('latitude', data=lat_lon[..., 0])
            f.create_dataset('longitude', data=lat_lon[..., 1])
            for key, arr in out.items():
                f.create_dataset(key, data=arr)
            f.attrs['cfg'] = safe_serialize(self.factor_cfg(extra_attrs))
        logger.info('Wrote bias factors to %s', fp_out)


class ScalarCorrection(LinearCorrection):
    """Mean-ratio scalar only (adder = 0); good for wind (reference:
    bias_calc.py:256)."""

    @staticmethod
    def get_linear_correction(bias_data, base_data, bias_feature,
                              base_dset):
        bias_mean = np.nanmean(bias_data)
        base_mean = np.nanmean(base_data)
        scalar = np.where(bias_mean == 0, 1.0, base_mean / bias_mean)
        return {
            f'bias_{bias_feature}_mean': bias_mean,
            f'bias_{bias_feature}_std': np.nanstd(bias_data),
            f'base_{base_dset}_mean': base_mean,
            f'base_{base_dset}_std': np.nanstd(base_data),
            f'{bias_feature}_scalar': float(scalar),
            f'{bias_feature}_adder': 0.0,
        }


class _MonthlyMixin:
    """Monthly per-gid stats with NT=12 layers."""

    NT = 12

    def _stats_single(self, bias_data, base_data, bias_ti, base_ti):
        keys = None
        out = {}
        bias_month, base_month = bias_ti.month, base_ti.month
        for month in range(1, 13):
            bias_m = bias_data[bias_month == month]
            base_m = base_data[base_month == month]
            if len(bias_m) and len(base_m):
                single = self.get_linear_correction(
                    bias_m, base_m, self.bias_feature, self.base_dset)
            else:
                if keys is None:
                    keys = list(self.get_linear_correction(
                        bias_data, base_data, self.bias_feature,
                        self.base_dset))
                single = {k: np.nan for k in keys}
            for k, v in single.items():
                out.setdefault(k, []).append(v)
        return {k: np.asarray(v, dtype=np.float32)
                for k, v in out.items()}


class MonthlyLinearCorrection(_MonthlyMixin, LinearCorrection):
    """Monthly scalar/adder factors (reference: bias_calc.py:311)."""


class MonthlyScalarCorrection(_MonthlyMixin, ScalarCorrection):
    """Monthly mean-ratio factors (reference: bias_calc.py:344)."""


class SkillAssessment(LinearCorrection):
    """Correction factors + distribution skill statistics (KS test,
    percentiles; reference: bias_calc.py:379-538)."""

    PERCENTILES = (1, 5, 25, 50, 75, 95, 99)

    def _init_out(self):
        out = super()._init_out()
        shape = (*self.bias_gid_raster.shape, self.NT)
        extra = [f'{self.bias_feature}_ks_stat',
                 f'{self.bias_feature}_ks_p',
                 f'{self.bias_feature}_bias']
        for k in extra:
            out[k] = np.full(shape, np.nan, np.float32)
        for p in self.PERCENTILES:
            out[f'bias_{self.bias_feature}_percentile_{p}'] = np.full(
                shape, np.nan, np.float32)
            out[f'base_{self.base_dset}_percentile_{p}'] = np.full(
                shape, np.nan, np.float32)
        return out

    def _stats_single(self, bias_data, base_data, bias_ti, base_ti):
        out = super()._stats_single(bias_data, base_data, bias_ti,
                                    base_ti)
        ks = stats.ks_2samp(base_data, bias_data)
        out[f'{self.bias_feature}_ks_stat'] = np.array(
            [ks.statistic], dtype=np.float32)
        out[f'{self.bias_feature}_ks_p'] = np.array(
            [ks.pvalue], dtype=np.float32)
        out[f'{self.bias_feature}_bias'] = np.array(
            [np.nanmean(bias_data) - np.nanmean(base_data)],
            dtype=np.float32)
        for p in self.PERCENTILES:
            out[f'bias_{self.bias_feature}_percentile_{p}'] = np.array(
                [np.nanpercentile(bias_data, p)], dtype=np.float32)
            out[f'base_{self.base_dset}_percentile_{p}'] = np.array(
                [np.nanpercentile(base_data, p)], dtype=np.float32)
        return out
