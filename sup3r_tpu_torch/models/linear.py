"""LinearInterp: the tri-linear interpolation baseline model.

Reference parity: sup3r/models/linear.py:15-171. The port's copy of
``sup3r_tpu/models/linear.py``: ``generate`` interpolates the whole
batch in one pass on the model's device (``ops.interp.st_interp_axes``).
"""

import json
import logging
import os
from inspect import signature

import torch

from sup3r_tpu_torch.models.abstract import AbstractInterface
from sup3r_tpu_torch.ops.interp import st_interp_axes
from sup3r_tpu_torch.utilities import resolve_device

logger = logging.getLogger(__name__)


class LinearInterp(AbstractInterface):
    """Baseline spatiotemporal bilinear/trilinear interpolation model."""

    def __init__(self, lr_features, s_enhance, t_enhance, t_centered=False,
                 input_resolution=None, device='cuda'):
        self._lr_features = [f.lower() for f in lr_features]
        self._s_enhance = s_enhance
        self._t_enhance = t_enhance
        self._t_centered = t_centered
        self._input_resolution = input_resolution
        self.device = resolve_device(device)

    @classmethod
    def load(cls, model_dir, verbose=False, device='cuda'):
        """Load from a directory holding ``model_params.json``."""
        with open(os.path.join(model_dir, 'model_params.json')) as f:
            meta = json.load(f)['meta']
        args = signature(cls.__init__).parameters
        return cls(**{k: v for k, v in meta.items()
                      if k in args and k != 'device'}, device=device)

    @property
    def meta(self):
        return {
            'input_resolution': self._input_resolution,
            'lr_features': self._lr_features,
            's_enhance': self._s_enhance,
            't_enhance': self._t_enhance,
            't_centered': self._t_centered,
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
        return []

    @property
    def input_dims(self):
        return 5

    def save(self, out_dir):
        """Write model_params.json."""
        self.save_params(out_dir)

    def generate(self, low_res, norm_in=False, un_norm_out=False,
                 exogenous_data=None):
        """Interpolate a 5D (n, s1, s2, t, f) batch (numpy or tensor) to
        the enhanced grid on ``self.device``; returns float32 numpy."""
        low_res = torch.as_tensor(low_res, dtype=torch.float32,
                                  device=self.device)
        hi_res = st_interp_axes(low_res, self._s_enhance, self._t_enhance,
                                t_centered=self._t_centered,
                                axes=(1, 2, 3))
        return hi_res.cpu().numpy()
