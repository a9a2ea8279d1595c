"""Multi-step model chains: serial GANs (and ``LinearInterp`` steps), and
the Sup3rCC solar composite.

Reference parity: sup3r/models/multi_step.py:20-886 (MultiStepGan :23,
SolarMultiStepGan :484). The port's copy of ``MultiStepGan`` and
``SolarMultiStepGan`` of ``sup3r_tpu/models/multi_step.py``: between two
steps the intermediate stays on the models' device as a tensor (each
member's ``generate(fetch=False)``) while the arithmetic is the JAX
chain's: each step denormalizes its output, and the next normalizes it
with its own stats. The solar composite's two spatial groups, their
concat, the temporal group and its reflect pad all run on the device; it
fetches once, at the end. ``MultiStepSurfaceMetGan`` chains the physics
``SurfaceSpatialMetModel`` and a temporal GAN; the surface output stays on
the device for the GAN.
"""

import json
import logging
import os

import numpy as np
import torch

from sup3r_tpu_torch.models.abstract import AbstractInterface, supports_fetch
from sup3r_tpu_torch.models.solar_cc import reflect_pad_time
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
        return self._run(low_res, norm_in, un_norm_out, exogenous_data,
                         fetch=True)

    def _run(self, low_res, norm_in, un_norm_out, exogenous_data, fetch):
        """``generate``; with ``fetch=False`` the last step's output stays
        on the device too where that step can hand it back."""
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
            if ((i < last or not fetch) and supports_fetch(type(model))
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


class MultiStepSurfaceMetGan(MultiStepGan):
    """Two-step chain: ``SurfaceSpatialMetModel`` (4D spatial met
    physics), then a (spatio)temporal GAN (reference: multi_step.py:340).
    The surface step's output stays on the models' device."""

    def generate(self, low_res, norm_in=True, un_norm_out=True,
                 exogenous_data=None):
        assert low_res.ndim == 4, (
            'MultiStepSurfaceMetGan needs 4D (t, s1, s2, f) input')
        assert exogenous_data is not None and (
            'topography' in exogenous_data), (
            'MultiStepSurfaceMetGan needs topography exogenous_data with '
            'low- and high-res steps')
        return super().generate(low_res, norm_in, un_norm_out,
                                exogenous_data)

    @classmethod
    def load(cls, surface_model_class='SurfaceSpatialMetModel',
             temporal_model_class='MultiStepGan', surface_model_kwargs=None,
             temporal_model_kwargs=None, verbose=True, device='cuda'):
        """Load the surface model and the temporal model (a chain's
        members join this chain) from their kwargs onto ``device``
        (reference: multi_step.py:440)."""
        from sup3r_tpu_torch import models as models_mod

        SurfaceClass = getattr(models_mod, surface_model_class)
        TemporalClass = getattr(models_mod, temporal_model_class)
        surface = SurfaceClass.load(verbose=verbose, device=device,
                                    **(surface_model_kwargs or {}))
        temporal = TemporalClass.load(verbose=verbose, device=device,
                                      **(temporal_model_kwargs or {}))
        return cls([surface, *getattr(temporal, 'models', [temporal])])


class SolarMultiStepGan(MultiStepGan):
    """Sup3rCC solar composite: parallel spatial clearsky-ratio and
    spatial wind groups, concatenated into the temporal (SolarCC) group
    (reference: multi_step.py:484-886). ``models`` is the wind group and
    the temporal group, as in the JAX package (the exo steps follow it);
    ``groups`` holds all three groups, ``all_models`` their members."""

    def __init__(self, spatial_solar_models, spatial_wind_models,
                 temporal_solar_models, t_enhance=None):
        super().__init__(models=[*spatial_wind_models.models,
                                 *temporal_solar_models.models])
        self._spatial_solar_models = spatial_solar_models
        self._spatial_wind_models = spatial_wind_models
        self._temporal_solar_models = temporal_solar_models
        self._t_enhance = t_enhance
        self.preflight()
        if t_enhance is not None:
            assert len(temporal_solar_models.models) == 1, (
                'Can only override t_enhance for a single temporal model')
            temporal_solar_models.models[0].meta['t_enhance'] = t_enhance

    def preflight(self):
        """Consistency checks across the three groups (the solar group
        takes clearsky_ratio alone: no exo, so no topography)."""
        s_enh = np.prod(self._spatial_solar_models.s_enhancements)
        w_enh = np.prod(self._spatial_wind_models.s_enhancements)
        assert s_enh == w_enh, (
            f'Solar ({s_enh}) and wind ({w_enh}) spatial enhancements must '
            'match')
        assert self._spatial_solar_models.lr_features == [
            'clearsky_ratio'], (
            'Spatial solar models must input only clearsky_ratio')
        assert self._spatial_solar_models.hr_out_features == [
            'clearsky_ratio'], (
            'Spatial solar models must output only clearsky_ratio')
        t_feats = self._temporal_solar_models.lr_features
        assert t_feats[0] == 'clearsky_ratio', (
            'Temporal solar model input feature 0 must be clearsky_ratio, '
            f'got {t_feats}')
        available = (self._spatial_wind_models.hr_out_features
                     + self._spatial_solar_models.hr_out_features)
        missing = [f for f in t_feats if f not in available]
        assert not missing, (f'Temporal solar model needs {missing} not '
                             'produced by the spatial models')

    @property
    def spatial_solar_models(self):
        return self._spatial_solar_models

    @property
    def spatial_wind_models(self):
        return self._spatial_wind_models

    @property
    def temporal_solar_models(self):
        return self._temporal_solar_models

    @property
    def groups(self):
        """(spatial solar, spatial wind, temporal solar) chains."""
        return (self._spatial_solar_models, self._spatial_wind_models,
                self._temporal_solar_models)

    @property
    def all_models(self):
        """Every member of the three groups."""
        return [m for g in self.groups for m in g.models]

    @property
    def inference_mode(self):
        """The common mode of every member of the three groups, or
        ``'custom'`` if they disagree."""
        modes = {m.inference_mode for m in self.all_models
                 if hasattr(type(m), 'inference_mode')}
        if len(modes) == 1:
            return modes.pop()
        return 'custom' if modes else 'exact'

    @inference_mode.setter
    def inference_mode(self, mode):
        for group in self.groups:
            group.inference_mode = mode

    @property
    def meta(self):
        return (self._spatial_solar_models.meta
                + self._spatial_wind_models.meta
                + self._temporal_solar_models.meta)

    @property
    def lr_features(self):
        return (self._spatial_solar_models.lr_features
                + self._spatial_wind_models.lr_features)

    @property
    def hr_out_features(self):
        return self._temporal_solar_models.hr_out_features

    @property
    def idf_wind(self):
        """Input channel indices of the wind group (less topography)."""
        return np.array([self.lr_features.index(f)
                         for f in self._spatial_wind_models.lr_features
                         if f != 'topography'])

    @property
    def idf_solar(self):
        """Input channel indices of the solar group (less topography)."""
        return np.array([self.lr_features.index(f)
                         for f in self._spatial_solar_models.lr_features
                         if f != 'topography'])

    @property
    def idf_wind_out(self):
        """Wind output channels the temporal group takes."""
        t_feats = self._temporal_solar_models.lr_features
        return np.array([
            self._spatial_wind_models.hr_out_features.index(f)
            for f in t_feats[1:]])

    def generate(self, low_res, norm_in=True, un_norm_out=True,
                 exogenous_data=None):
        """4D (t, s1, s2, f) in -> 5D (1, s1, s2, t * t_enhance, 1)
        clearsky ratio out, a float32 numpy array. The spatial groups take
        the input channels of their features, the solar group no exo; the
        temporal group takes the solar output then the wind outputs it
        needs, and the exo steps after the wind group's."""
        if isinstance(exogenous_data, dict) and not isinstance(
                exogenous_data, ExoData):
            exogenous_data = ExoData(exogenous_data)
        if exogenous_data is not None:
            s_exo, t_exo = exogenous_data.split(
                [len(self._spatial_wind_models)])
        else:
            s_exo = t_exo = None
        device = self.device
        low_res = torch.as_tensor(np.asarray(low_res, dtype=np.float32)
                                  if not isinstance(low_res, torch.Tensor)
                                  else low_res, device=device)
        hi_res_wind = self._spatial_wind_models._run(
            low_res[..., self.idf_wind.tolist()], norm_in, True, s_exo,
            fetch=False)
        hi_res_solar = self._spatial_solar_models._run(
            low_res[..., self.idf_solar.tolist()], norm_in, True, None,
            fetch=False)
        hi_res_wind = torch.as_tensor(hi_res_wind, device=device)
        hi_res_solar = torch.as_tensor(hi_res_solar, device=device)
        with torch.inference_mode():
            hi_res = torch.cat(
                [hi_res_solar, hi_res_wind[..., self.idf_wind_out.tolist()]],
                dim=3)
            hi_res = hi_res.permute(1, 2, 0, 3)[None]
        hi_res = self._temporal_solar_models._run(
            hi_res, True, un_norm_out, t_exo, fetch=False)
        with torch.inference_mode():
            hi_res = self.temporal_pad(low_res, hi_res)
        if isinstance(hi_res, torch.Tensor):
            hi_res = hi_res.cpu().numpy()
        return hi_res

    def temporal_pad(self, low_res, hi_res, mode='reflect'):
        """Reflect the output's time axis to t_in * t_enhance (SolarCC
        crops to its daylight hours; reference: multi_step.py:824)."""
        if mode != 'reflect':
            raise ValueError(f'temporal_pad mode must be "reflect", got '
                             f'{mode!r}')
        t_shape = low_res.shape[0] * self.t_enhance
        return reflect_pad_time(hi_res, int((t_shape - hi_res.shape[-2])
                                            / 2))

    @classmethod
    def load(cls, spatial_solar_model_dirs, spatial_wind_model_dirs,
             temporal_solar_model_dirs, t_enhance=None, verbose=True,
             device='cuda'):
        """Load the three groups from their save directories onto
        ``device``."""
        groups = [MultiStepGan.load(dirs, verbose=verbose, device=device)
                  for dirs in (spatial_solar_model_dirs,
                               spatial_wind_model_dirs,
                               temporal_solar_model_dirs)]
        return cls(*groups, t_enhance=t_enhance)
