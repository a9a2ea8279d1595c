"""Sup3rGanWithObs: a GAN that fuses sparse observations.

Reference parity: sup3r/models/with_obs.py:29-291. The port's copy of
``sup3r_tpu/models/with_obs.py``. In training, a random subset of the
true high-res field is shown to the generator as "observations" (NaN
elsewhere, through its ``Sup3rConcatObs`` / ``Sup3rObsModel`` layers),
and a masked MAE at the observed cells joins the content loss. The mask
is a spatial mask, constant over time, times a ``time_frac`` mask of the
time steps (5D), the same for every output channel. The JAX package draws
it with ``jax.random``; the port draws it from a CPU ``torch.Generator``
seeded with the step counter (validation: one generator per
``calc_val_loss``), so a model on the card and one on the CPU at the same
step draw the same mask, and moves it to the model's device.
"""

import logging

import torch

from sup3r_tpu_torch.models.gan import Sup3rGan
from sup3r_tpu_torch.names import strip_obs_suffix

logger = logging.getLogger(__name__)


def _masked_mae(a, b, weights):
    """MAE over the cells where ``weights`` is 1; 0 (not NaN) when no
    cell is."""
    w = weights.to(a.dtype)
    return torch.sum(torch.abs(a - b) * w) / torch.clamp(torch.sum(w),
                                                         min=1.0)


class Sup3rGanWithObs(Sup3rGan):
    """GAN with observation fusion layers and an observation loss."""

    _spatial_refusal = (
        "its observation mask is drawn for whole samples")

    def __init__(self, *args, onshore_obs_frac=None, offshore_obs_frac=None,
                 loss_obs=None, loss_obs_weight=0.1, **kwargs):
        """``onshore_obs_frac`` / ``offshore_obs_frac``: dicts with
        ``'spatial_frac'`` (a float or [lo, hi] bounds) and an optional
        ``'time_frac'``. ``loss_obs`` names the observation loss, a
        masked mean absolute error."""
        super().__init__(*args, **kwargs)
        self.onshore_obs_frac = onshore_obs_frac or {}
        self.offshore_obs_frac = offshore_obs_frac or {}
        self.loss_obs_weight = loss_obs_weight
        self.loss_obs_name = loss_obs or 'MeanAbsoluteError'
        self._val_generator = None

    @property
    def obs_training_inds(self):
        """HR channel index of each observation feature's base
        feature."""
        hr_feats = [strip_obs_suffix(f) for f in self.hr_features]
        return [hr_feats.index(strip_obs_suffix(f))
                for f in self.obs_features]

    def _spatial_frac_bounds(self):
        frac = self.onshore_obs_frac.get('spatial_frac', 0.1)
        if isinstance(frac, (int, float)):
            return float(frac), float(frac)
        return float(frac[0]), float(frac[1])

    def _sample_obs_mask(self, hr_shape, generator):
        """Boolean mask of ``hr_shape``, True where NOT observed, drawn
        on the CPU from ``generator`` and moved to the model's device: a
        fraction drawn within the spatial bounds, a spatial mask constant
        over time and (5D) a ``time_frac`` mask of the time steps. One
        mask serves every sample, so the ranks of a data-parallel step,
        each drawing from the same seed, hold the global batch's."""
        lo, hi = self._spatial_frac_bounds()
        time_frac = float(self.onshore_obs_frac.get('time_frac', 1.0))
        frac = lo + (hi - lo) * torch.rand((), generator=generator)
        mask = torch.rand(tuple(hr_shape[1:3]),
                          generator=generator) <= frac
        if len(hr_shape) == 5:
            t_mask = torch.rand((hr_shape[3],),
                                generator=generator) <= time_frac
            mask = mask[:, :, None] & t_mask[None, None, :]
        mask = mask[None, ..., None].expand(tuple(hr_shape))
        return (~mask).to(self.device)

    def _obs_exo(self, hr, generator):
        """(exo rasters with the observation rasters, not-observed mask)
        of an HR batch: each observation raster is its base channel of
        ``hr``, NaN where not observed (one mask for every channel)."""
        exo = self._split_exo(hr)
        n_out = hr.shape[-1] - len(self.hr_exo_features)
        not_obs = self._sample_obs_mask((*hr.shape[:-1], n_out), generator)
        for name, idx in zip(self.obs_features, self.obs_training_inds):
            exo[name] = torch.where(not_obs[..., :1], torch.nan,
                                    hr[..., idx:idx + 1])
        return exo, not_obs

    def _extra_gen_loss(self, out, hr, not_obs):
        """(weighted observation loss, its details) of a generated batch:
        the masked MAE at observed and at unobserved cells, and the
        observed fraction (``Sup3rGan``'s train and validation steps add
        it to the content loss)."""
        n_exo = len(self.hr_exo_features)
        true = hr[..., :hr.shape[-1] - n_exo]
        obs_w = (~not_obs).to(out.dtype)
        loss_obs = _masked_mae(out, true, obs_w)
        return self.loss_obs_weight * loss_obs, {
            'loss_obs': loss_obs,
            'loss_non_obs': _masked_mae(out, true, not_obs.to(out.dtype)),
            'obs_frac': torch.mean(obs_w)}

    def _train_exo(self, hr):
        generator = torch.Generator().manual_seed(self._step_counter)
        return self._obs_exo(hr, generator)

    def calc_val_loss(self, batch_handler, weight_gen_advers):
        """Mean validation losses; the masks of the validation batches
        come from one generator seeded with 0."""
        self._val_generator = torch.Generator().manual_seed(0)
        return super().calc_val_loss(batch_handler, weight_gen_advers)

    def _val_exo(self, hr):
        if self._val_generator is None:
            self._val_generator = torch.Generator().manual_seed(0)
        return self._obs_exo(hr, self._val_generator)

    # save / load
    @property
    def model_params(self):
        params = super().model_params
        params.update({
            'onshore_obs_frac': self.onshore_obs_frac,
            'offshore_obs_frac': self.offshore_obs_frac,
            'loss_obs_weight': self.loss_obs_weight,
            'loss_obs': self.loss_obs_name,
        })
        return params

    @classmethod
    def _extra_load_kwargs(cls, params):
        """The observation settings saved beside the GAN's."""
        return {
            'onshore_obs_frac': params.get('onshore_obs_frac'),
            'offshore_obs_frac': params.get('offshore_obs_frac'),
            'loss_obs': params.get('loss_obs'),
            'loss_obs_weight': params.get('loss_obs_weight', 0.1),
        }
