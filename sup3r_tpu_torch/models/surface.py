"""SurfaceSpatialMetModel: the physics (non-network) spatial downscaler
of near-surface temperature, relative humidity and pressure.

Reference parity: sup3r/models/surface.py:27-827. The port's copy of
``sup3r_tpu/models/surface.py``: temperature by a lapse rate, relative
humidity by a regression on the delta-T / delta-topography residuals,
pressure by the barometric formula, every other feature by plain
resampling, each with the low-res-consistency bias fix. The JAX package
resizes each field with PIL; the port resizes a whole batch of fields at
once with the same Pillow filters as two small matmuls on the model's
device (``ops/resample.py``), in ``dtype`` (float32; float64 for a
reference run on the CPU). The model takes physical units: it has no
normalization stats and no parameters.
"""

import json
import logging
import os
from inspect import signature

import numpy as np
import torch

from sup3r_tpu_torch.models.abstract import AbstractInterface
from sup3r_tpu_torch.names import parse_feature
from sup3r_tpu_torch.ops.resample import check_method, resize
from sup3r_tpu_torch.utilities import (
    RANDOM_GENERATOR,
    exact_fp32,
    resolve_device,
)

logger = logging.getLogger(__name__)


def _block_mean(hr, s_enhance):
    """Block-mean coarsening of the last two axes of ``hr`` by
    ``s_enhance``."""
    *lead, h, w = hr.shape
    blocks = hr.reshape(*lead, h // s_enhance, s_enhance, w // s_enhance,
                        s_enhance)
    return blocks.mean(dim=(-3, -1))


class SurfaceSpatialMetModel(AbstractInterface):
    """Physics downscaler for temperature_*m / relativehumidity_*m /
    pressure_*m (other features are resampled)."""

    #: temperature lapse rate (deg C/K per meter)
    TEMP_LAPSE = 6.5 / 1000
    #: pressure scale-height divisor: 101325*(1-(1-topo/DIV)**EXP)
    PRES_DIV = 44307.69231
    PRES_EXP = 5.25328
    #: RH regression weights on (delta_temp, delta_topo)
    W_DELTA_TEMP = -3.99242830
    W_DELTA_TOPO = -0.01736911

    #: the dtype the fields are computed in
    dtype = torch.float32

    def __init__(self, lr_features, s_enhance, noise_adders=None,
                 temp_lapse=None, w_delta_temp=None, w_delta_topo=None,
                 pres_div=None, pres_exp=None, interp_method='LANCZOS',
                 input_resolution=None, fix_bias=True, device='cuda'):
        self._lr_features = [f.lower() for f in lr_features]
        self._s_enhance = s_enhance
        self._noise_adders = noise_adders
        self._temp_lapse = temp_lapse or self.TEMP_LAPSE
        self._w_delta_temp = w_delta_temp or self.W_DELTA_TEMP
        self._w_delta_topo = w_delta_topo or self.W_DELTA_TOPO
        self._pres_div = pres_div or self.PRES_DIV
        self._pres_exp = pres_exp or self.PRES_EXP
        self._fix_bias = fix_bias
        self._interp_name = interp_method
        self._interp_method = check_method(interp_method)
        self._input_resolution = input_resolution
        if isinstance(noise_adders, (int, float)):
            self._noise_adders = [noise_adders] * len(lr_features)
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, model_dir, verbose=False, device='cuda'):
        """Load from the ``model_params.json`` that either package's
        ``save`` writes."""
        with open(os.path.join(model_dir, 'model_params.json')) as f:
            meta = json.load(f)['meta']
        args = signature(cls.__init__).parameters
        return cls(**{k: v for k, v in meta.items()
                      if k in args and k != 'device'}, device=device)

    def save(self, out_dir):
        """Write model_params.json (the JAX package's layout)."""
        self.save_params(out_dir)

    @property
    def meta(self):
        return {
            'lr_features': self._lr_features,
            's_enhance': self._s_enhance,
            't_enhance': 1,
            'noise_adders': self._noise_adders,
            'temp_lapse': self._temp_lapse,
            'w_delta_temp': self._w_delta_temp,
            'w_delta_topo': self._w_delta_topo,
            'pres_div': self._pres_div,
            'pres_exp': self._pres_exp,
            'interp_method': self._interp_name,
            'fix_bias': self._fix_bias,
            'input_resolution': self._input_resolution,
            'hr_out_features': self.hr_out_features,
            'class': type(self).__name__,
        }

    @meta.setter
    def meta(self, value):
        pass

    @property
    def lr_features(self):
        return self._lr_features

    @property
    def hr_out_features(self):
        return self._lr_features

    @property
    def hr_exo_features(self):
        # topography enters as the input and output exo steps that
        # ExoDataHandler.get_exo_steps gives a surface model
        return []

    @property
    def input_dims(self):
        return 4

    @property
    def is_4d(self):
        return True

    @staticmethod
    def _has_output_exo(exogenous_data):
        """The model reads its topography steps itself: no exo step
        forces a host concat."""
        return False

    # feature-index helpers -------------------------------------------
    def _inds(self, base):
        return [i for i, f in enumerate(self._lr_features)
                if parse_feature(f)[0] == base]

    @property
    def feature_inds_temp(self):
        """Indices of temperature features."""
        return self._inds('temperature')

    @property
    def feature_inds_rh(self):
        """Indices of relative humidity features."""
        return self._inds('relativehumidity')

    @property
    def feature_inds_pres(self):
        """Indices of pressure features."""
        return self._inds('pressure')

    @property
    def feature_inds_other(self):
        """Everything else."""
        known = (set(self.feature_inds_temp) | set(self.feature_inds_rh)
                 | set(self.feature_inds_pres))
        return [i for i in range(len(self._lr_features)) if i not in known]

    def _get_temp_rh_ind(self, idf_rh):
        """Temperature channel matching an RH channel's height."""
        suffix = self._lr_features[idf_rh].split('_')[-1]
        for i in self.feature_inds_temp:
            if self._lr_features[i].split('_')[-1] == suffix:
                return i
        raise KeyError(
            f'Could not find temperature feature matching '
            f'"{self._lr_features[idf_rh]}" (needed for RH downscaling)')

    # core physics, on (..., s1, s2) tensors ---------------------------
    @classmethod
    def fix_downscaled_bias(cls, single_lr, single_hr, method='LANCZOS'):
        """Remove the low-res-mean bias from downscaled fields."""
        s_enhance = single_hr.shape[-2] // single_lr.shape[-2]
        bias = _block_mean(single_hr, s_enhance) - single_lr
        return single_hr - cls.downscale_arr(bias, s_enhance, method=method)

    @classmethod
    def downscale_arr(cls, arr, s_enhance, method='LANCZOS',
                      fix_bias=False):
        """Resample the last two axes of ``arr`` by ``s_enhance`` with
        PIL's filter ``method``."""
        out = resize(arr, (arr.shape[-2] * s_enhance,
                           arr.shape[-1] * s_enhance), method)
        if fix_bias:
            out = cls.fix_downscaled_bias(arr, out, method=method)
        return out

    def downscale_temp(self, single_lr_temp, topo_lr, topo_hr):
        """Lapse-rate-corrected temperature downscaling."""
        lower = single_lr_temp + topo_lr * self._temp_lapse
        hi = self.downscale_arr(lower, self._s_enhance,
                                method=self._interp_method)
        hi = hi - topo_hr * self._temp_lapse
        if self._fix_bias:
            hi = self.fix_downscaled_bias(single_lr_temp, hi,
                                          method=self._interp_method)
        return hi

    def downscale_rh(self, single_lr_rh, single_lr_temp, single_hr_temp,
                     topo_lr, topo_hr):
        """RH downscaling: resampling plus linear corrections from the
        delta-T and delta-topography residuals."""
        interp_rh = self.downscale_arr(single_lr_rh, self._s_enhance,
                                       method=self._interp_method)
        interp_temp = self.downscale_arr(single_lr_temp, self._s_enhance,
                                         method=self._interp_method)
        interp_topo = self.downscale_arr(topo_lr, self._s_enhance,
                                         method=self._interp_method)
        hi = (interp_rh
              + self._w_delta_temp * (single_hr_temp - interp_temp)
              + self._w_delta_topo * (topo_hr - interp_topo))
        if self._fix_bias:
            hi = self.fix_downscaled_bias(single_lr_rh, hi,
                                          method=self._interp_method)
        return hi

    def _pres_scale(self, topo):
        return 101325 * (1 - (1 - topo / self._pres_div) ** self._pres_exp)

    def downscale_pres(self, single_lr_pres, topo_lr, topo_hr):
        """Barometric-formula-corrected pressure downscaling; negative
        values are clipped to 0."""
        if float(single_lr_pres.max()) < 10000:
            logger.warning('Pressure data appears to not be in Pa')
        lower = single_lr_pres + self._pres_scale(topo_lr)
        hi = self.downscale_arr(lower, self._s_enhance,
                                method=self._interp_method)
        hi = torch.clamp(hi - self._pres_scale(topo_hr), min=0.0)
        if self._fix_bias:
            hi = self.fix_downscaled_bias(single_lr_pres, hi,
                                          method=self._interp_method)
        return hi

    # ------------------------------------------------------------------
    def _field(self, arr):
        """``arr`` as a tensor of ``dtype`` on the model's device."""
        if not isinstance(arr, torch.Tensor):
            arr = torch.as_tensor(np.asarray(arr))
        return arr.to(device=self.device, dtype=self.dtype)

    def train(self, true_hr_temp, true_hr_rh, true_hr_topo,
              input_resolution):
        """Fit the two RH regression weights from true high-res fields
        (reference: sup3r/models/surface.py:735-827): the truths are
        coarsened, resampled back with LANCZOS, and the RH residual is
        regressed with zero intercept on the temperature and topography
        residuals.

        Parameters
        ----------
        true_hr_temp, true_hr_rh : np.ndarray
            True high-res daily temperature and relative humidity,
            (lat, lon, n_days).
        true_hr_topo : np.ndarray
            High-res surface elevation in meters, (lat, lon).
        input_resolution : dict
            e.g. ``{'spatial': '20km', 'temporal': '60min'}``, recorded
            on the model's meta.

        Returns
        -------
        w_delta_temp, w_delta_topo : float
            The fitted weights.
        regr : object
            The zero-intercept fit (``coef_``, ``intercept_``,
            ``predict(x)``).
        x : np.ndarray
            (n, 2) regression inputs (delta-temp, delta-topo).
        y : np.ndarray
            (n,) regression target (delta-RH).
        """
        true_hr_temp = np.asarray(true_hr_temp)
        true_hr_rh = np.asarray(true_hr_rh)
        true_hr_topo = np.asarray(true_hr_topo)
        assert true_hr_temp.ndim == 3, 'Bad true_hr_temp shape'
        assert true_hr_rh.ndim == 3, 'Bad true_hr_rh shape'
        assert true_hr_topo.ndim == 2, 'Bad true_hr_topo shape'
        self._input_resolution = input_resolution

        def _residual(hr_field):
            # truth minus its coarsen -> LANCZOS reconstruction, per day
            # (the reference uses downscale_arr's default method here,
            # not the model's interp_method)
            hr = self._field(hr_field).movedim(-1, 0)
            lr = _block_mean(hr, self._s_enhance)
            interp = self.downscale_arr(lr, self._s_enhance)
            return (hr - interp).movedim(0, -1).cpu().double().numpy()

        with torch.no_grad(), exact_fp32():
            topo_days = np.repeat(true_hr_topo[..., None],
                                  true_hr_temp.shape[-1], axis=-1)
            x = np.vstack((_residual(true_hr_temp).ravel(),
                           _residual(topo_days).ravel())).T
            y = _residual(true_hr_rh).ravel()
        coef, *_ = np.linalg.lstsq(x, y, rcond=None)

        class _LinearFit:
            coef_ = coef
            intercept_ = 0.0

            @staticmethod
            def predict(xq):
                return np.asarray(xq) @ coef

        w_delta_temp, w_delta_topo = float(coef[0]), float(coef[1])
        logger.info(
            'Trained RH model weights: w_delta_temp=%.6f '
            'w_delta_topo=%.6f (defaults %.6f / %.6f)', w_delta_temp,
            w_delta_topo, self.W_DELTA_TEMP, self.W_DELTA_TOPO)
        return w_delta_temp, w_delta_topo, _LinearFit(), x, y

    # ------------------------------------------------------------------
    def _get_topo_from_exo(self, exogenous_data):
        """(lr_topo, hr_topo) 2D tensors on the device from the exo
        dict's two topography steps (low-res, then high-res)."""
        steps = exogenous_data['topography']['steps']
        assert len(steps) == 2, (
            'SurfaceSpatialMetModel needs exactly 2 topography steps '
            '(low-res then high-res)')
        out = []
        for step in steps:
            topo = self._field(step['data'])
            if topo.ndim == 4:
                topo = topo[0, :, :, 0]
            if topo.ndim == 3:
                topo = topo[..., 0]
            out.append(topo)
        return tuple(out)

    def generate(self, low_res, norm_in=False, un_norm_out=False,
                 exogenous_data=None, fetch=True):
        """Downscale a 4D (n, s1, s2, f) batch of physical-units met data
        (numpy or tensor) on the model's device. ``norm_in`` /
        ``un_norm_out`` are accepted for the chain's API and ignored: the
        model has no stats. Returns float32 numpy, or with
        ``fetch=False`` the tensor on the device."""
        low_res = self._field(low_res)
        lr_topo, hr_topo = self._get_topo_from_exo(exogenous_data)
        assert tuple(lr_topo.shape) == tuple(low_res.shape[1:3]), (
            f'lr topo shape {tuple(lr_topo.shape)} does not match input '
            f'{tuple(low_res.shape)}')
        s_enhance = hr_topo.shape[0] // lr_topo.shape[0]
        assert s_enhance == self._s_enhance, (
            f'Topo shapes suggest s_enhance={s_enhance}, model has '
            f'{self._s_enhance}')

        fields = low_res.permute(0, 3, 1, 2)
        out = [None] * len(self.hr_out_features)
        method = self._interp_method
        with torch.inference_mode(), exact_fp32():
            for idf in self.feature_inds_temp:
                out[idf] = self.downscale_temp(fields[:, idf], lr_topo,
                                               hr_topo)
            for idf in self.feature_inds_pres:
                out[idf] = self.downscale_pres(fields[:, idf], lr_topo,
                                               hr_topo)
            for idf in self.feature_inds_rh:
                idt = self._get_temp_rh_ind(idf)
                out[idf] = self.downscale_rh(fields[:, idf], fields[:, idt],
                                             out[idt], lr_topo, hr_topo)
            for idf in self.feature_inds_other:
                out[idf] = self.downscale_arr(fields[:, idf],
                                              self._s_enhance, method=method,
                                              fix_bias=self._fix_bias)
            hi_res = torch.stack(out, dim=-1)
            if self._noise_adders is not None:
                # numpy draws from the shared generator, in the JAX
                # package's order, so a seeded run adds the same noise
                for idf, stdev in enumerate(self._noise_adders):
                    if stdev is not None:
                        noise = RANDOM_GENERATOR.uniform(
                            0, stdev, tuple(hi_res.shape[:-1]))
                        hi_res[..., idf] += self._field(noise)
        if not fetch:
            return hi_res
        return hi_res.cpu().numpy().astype(np.float32)
