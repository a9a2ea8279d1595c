"""Multi-step model chains: serial GANs (and ``LinearInterp`` steps).

Reference parity: sup3r/models/multi_step.py:20-886 (MultiStepGan :23).
The port's copy of ``MultiStepGan`` of ``sup3r_tpu/models/multi_step.py``:
between two steps the intermediate stays on the models' device as a
tensor (each member's ``generate(fetch=False)``) while the arithmetic is
the JAX chain's: each step denormalizes its output, and the next
normalizes it with its own stats. ``MultiStepSurfaceMetGan`` and
``SolarMultiStepGan`` come with their members (ROADMAP queue 1 item 7).
"""

import json
import logging
import os

import numpy as np
import torch

from sup3r_tpu_torch.models.abstract import AbstractInterface, supports_fetch
from sup3r_tpu_torch.preprocessing.exo import ExoData

logger = logging.getLogger(__name__)


def _permute(x, *dims):
    """``np.transpose`` or ``Tensor.permute``."""
    return (x.permute(*dims) if isinstance(x, torch.Tensor)
            else np.transpose(x, dims))


class MultiStepGan(AbstractInterface):
    """Serial chain of one or more loaded models."""

    def __init__(self, models):
        self._models = tuple(models)

    def __len__(self):
        return len(self._models)

    @classmethod
    def load(cls, model_dirs, model_kwargs=None, verbose=True,
             device='cuda'):
        """Load each step's model from its save directory, dispatching on
        the 'class' in its ``model_params.json``. One ``model_kwargs``
        dict applies to every step; ``device`` reaches every member."""
        from sup3r_tpu_torch import models as models_mod

        if isinstance(model_dirs, str):
            model_dirs = [model_dirs]
        model_kwargs = model_kwargs or [{}] * len(model_dirs)
        if isinstance(model_kwargs, dict):
            # one dict for every step: a 1-element list would zip-truncate
            # the chain to its first model (the reference's defect,
            # multi_step.py:69-72)
            model_kwargs = [model_kwargs] * len(model_dirs)
        if len(model_kwargs) != len(model_dirs):
            raise ValueError(f'Got {len(model_kwargs)} model_kwargs for '
                             f'{len(model_dirs)} model_dirs')
        models = []
        for model_dir, kwargs in zip(model_dirs, model_kwargs):
            with open(os.path.join(model_dir, 'model_params.json')) as f:
                params = json.load(f)
            class_name = params.get('meta', {}).get('class', 'Sup3rGan')
            ModelClass = getattr(models_mod, class_name)
            models.append(ModelClass.load(
                model_dir, **{'verbose': verbose, 'device': device,
                              **kwargs}))
        return cls(models)

    @property
    def models(self):
        """Ordered tuple of the models in this chain."""
        return self._models

    @property
    def device(self):
        """The first member's device (``load`` puts every member there)."""
        return self._models[0].device

    @property
    def inference_mode(self):
        """Chain-level inference profile: the common mode of the members
        that have one, or ``'custom'`` if they disagree."""
        modes = {m.inference_mode for m in self._models
                 if hasattr(type(m), 'inference_mode')}
        if len(modes) == 1:
            return modes.pop()
        return 'custom' if modes else 'exact'

    @inference_mode.setter
    def inference_mode(self, mode):
        supported = [m for m in self._models
                     if hasattr(type(m), 'inference_mode')]
        if mode != 'exact' and not supported:
            raise ValueError(f'No member of this {type(self).__name__} '
                             f'supports inference_mode={mode!r}')
        for m in supported:
            m.inference_mode = mode

    @property
    def meta(self):
        """Tuple of each step's meta."""
        return tuple(m.meta for m in self._models)

    @property
    def means(self):
        return tuple(getattr(m, '_means', None) for m in self._models)

    @property
    def stdevs(self):
        return tuple(getattr(m, '_stdevs', None) for m in self._models)

    # enhancement and features -----------------------------------------
    @property
    def s_enhancements(self):
        return [m.s_enhance for m in self._models]

    @property
    def t_enhancements(self):
        return [m.t_enhance for m in self._models]

    @property
    def s_enhance(self):
        return int(np.prod(self.s_enhancements))

    @property
    def t_enhance(self):
        return int(np.prod(self.t_enhancements))

    @property
    def lr_features(self):
        """First model's input features."""
        return self._models[0].lr_features

    @property
    def hr_out_features(self):
        """Last model's output features."""
        return self._models[-1].hr_out_features

    @property
    def hr_exo_features(self):
        """Last model's exo features."""
        return self._models[-1].hr_exo_features

    @property
    def obs_features(self):
        return self._models[-1].obs_features

    @property
    def input_dims(self):
        return self._models[0].input_dims

    @property
    def is_4d(self):
        return self.input_dims == 4

    # ------------------------------------------------------------------
    @staticmethod
    def _transpose_model_input(model, hi_res):
        """Move between 4D (t, s1, s2, f) and 5D (1, s1, s2, t, f)
        layouts between steps (numpy array or tensor; reference:
        multi_step.py:128)."""
        if model.is_5d and hi_res.ndim == 4:
            return _permute(hi_res, 1, 2, 0, 3)[None]
        if model.is_4d and hi_res.ndim == 5:
            assert hi_res.shape[0] == 1, (
                f'Cannot feed batched 5D data {tuple(hi_res.shape)} to a '
                '4D model')
            return _permute(hi_res[0], 2, 0, 1, 3)
        assert model.input_dims == hi_res.ndim, (
            f'Shape {tuple(hi_res.shape)} does not fit a '
            f'{model.input_dims}D model')
        return hi_res

    def _match_model_input(self, model_step, hi_res, exo_data):
        """Select the previous step's output channels the next step needs
        (reference: multi_step.py:172)."""
        if model_step == 0:
            return hi_res
        current = self._models[model_step]
        output_feats = self._models[model_step - 1].hr_out_features
        exo_data = exo_data or {}
        input_feats = [f for f in current.lr_features if f not in exo_data]
        if not set(input_feats).issubset(output_feats):
            raise ValueError(f'Step {model_step} inputs {input_feats} not '
                             f'all in previous step outputs {output_feats}')
        idx = [output_feats.index(f) for f in input_feats]
        return hi_res[..., idx]

    def generate(self, low_res, norm_in=True, un_norm_out=True,
                 exogenous_data=None):
        """Run all steps in serial (reference: multi_step.py:196); the
        last step fetches, so this returns a float32 numpy array."""
        if isinstance(exogenous_data, dict) and not isinstance(
                exogenous_data, ExoData):
            exogenous_data = ExoData(exogenous_data)
        hi_res = (low_res if isinstance(low_res, torch.Tensor)
                  else np.asarray(low_res))
        last = len(self._models) - 1
        for i, model in enumerate(self._models):
            i_norm_in = not (i == 0 and not norm_in)
            i_un_norm_out = not (i == last and not un_norm_out)
            i_exo = (None if exogenous_data is None
                     else exogenous_data.get_model_step_exo(i))
            hi_res = self._transpose_model_input(model, hi_res)
            hi_res = self._match_model_input(i, hi_res, i_exo)
            kwargs = {}
            if (i < last and supports_fetch(type(model))
                    and not model._has_output_exo(i_exo)):
                # the intermediate stays on the device
                kwargs['fetch'] = False
            hi_res = model.generate(hi_res, norm_in=i_norm_in,
                                    un_norm_out=i_un_norm_out,
                                    exogenous_data=i_exo, **kwargs)
        return hi_res

    def save(self, out_dir):
        """Save each step's model to a numbered subdirectory."""
        for i, model in enumerate(self._models):
            model.save(os.path.join(out_dir, f'model_step_{i}'))
