"""SolarCC: the solar GAN trained on daily -> hourly clearsky ratio (the
port of ``sup3r_tpu/models/solar_cc.py``).

Loss structure (reference: sup3r/models/solar_cc.py:31-250):

- the discriminator sees only daylight-hour windows: a fixed daylight
  window of each day of the true sample, and a randomly placed window of
  the generated one (one start per day, uniform over the generated
  output's length, drawn from a ``torch.Generator`` seeded with the step
  counter: the JAX step draws from ``jax.random``, so the two packages'
  windows differ while their law is the same);
- the generator's content loss is the pointwise loss on each day's
  centre hours plus the loss of the generated 24-hour mean against the
  true daylight mean;
- the network's output covers fewer hours than ``t_in * t_enhance`` (a
  serving ``t_enhance`` of 24 on an 8x network), so ``generate`` reflects
  it back to that length on the model's device (``temporal_pad``, numpy's
  reflect, also where the pad is wider than the axis).

Each day's windows run through the discriminator as one batch (the days
stacked on the batch axis in day order), which gives the per-day calls'
concatenation. With a mesh attached the step is data parallel as
``Sup3rGan``'s: the discriminator outputs and the generated and true
batches are gathered (the relativistic loss reads only means, so the
rank-major order of the gathered outputs gives the same loss), and the
gradients are summed over the ranks.
"""

import logging

import numpy as np
import torch

from sup3r_tpu_torch.models.gan import Sup3rGan, relativistic_disc_loss
from sup3r_tpu_torch.models.layers import _pad_index
from sup3r_tpu_torch.ops.losses import apply_loss
from sup3r_tpu_torch.utilities import exact_fp32

logger = logging.getLogger(__name__)


def reflect_pad_time(hi_res, t_pad):
    """``np.pad(hi_res, t_pad on axis -2, mode='reflect')`` for a numpy
    array or a tensor (gathered on its device by index, so a pad as wide
    as the axis or wider reflects again, as numpy does)."""
    if t_pad <= 0:
        return hi_res
    if not isinstance(hi_res, torch.Tensor):
        width = [(0, 0)] * hi_res.ndim
        width[-2] = (t_pad, t_pad)
        return np.pad(hi_res, width, mode='reflect')
    idx = _pad_index(hi_res.shape[-2], t_pad, t_pad, 'reflect')
    return hi_res.index_select(hi_res.ndim - 2, torch.as_tensor(
        idx, device=hi_res.device))


class SolarCC(Sup3rGan):
    """Solar climate-change GAN with daylight-window losses."""

    _spatial_refusal = (
        "its own train step, whose discriminator sees daylight windows, "
        "runs on whole samples")

    #: zero-indexed hour daylight starts (after t_roll centering)
    STARTING_HOUR = 8
    #: number of daylight hours per day the discriminator sees
    DAYLIGHT_HOURS = 8
    #: centre-of-day hours of the pointwise content loss
    POINT_LOSS_HOURS = 2

    def __init__(self, *args, t_enhance=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._t_enhance_override = t_enhance
        if t_enhance is not None:
            self.meta['t_enhance'] = t_enhance

    def init_weights(self, lr_shape, hr_shape, seed=None):
        """The discriminator only ever sees DAYLIGHT_HOURS-long windows,
        so it is built on that temporal length."""
        hr_shape = (*hr_shape[:3], self.DAYLIGHT_HOURS, hr_shape[-1])
        super().init_weights(lr_shape, hr_shape, seed=seed)

    # ------------------------------------------------------------------
    # daylight windows
    @staticmethod
    def _n_days(hr):
        if hr.shape[3] % 24:
            raise ValueError('SolarCC needs multiples of 24 hourly steps, '
                             f'got {tuple(hr.shape)}')
        return hr.shape[3] // 24

    def true_windows(self, hr):
        """Each day's fixed daylight window of an HR batch, stacked on
        the batch axis in day order."""
        sh, dh = self.STARTING_HOUR, self.DAYLIGHT_HOURS
        return torch.cat([hr[:, :, :, 24 * i + sh:24 * i + sh + dh]
                          for i in range(self._n_days(hr))], dim=0)

    def gen_windows(self, out, starts):
        """The generated windows that start at ``starts`` (one per day),
        stacked on the batch axis in day order."""
        dh = self.DAYLIGHT_HOURS
        return torch.cat([out[:, :, :, t0:t0 + dh] for t0 in starts], dim=0)

    def draw_window_starts(self, n_days, t_len, generator):
        """One window start per day, uniform over [0, t_len -
        DAYLIGHT_HOURS], from the CPU ``torch.Generator``."""
        return torch.randint(0, t_len - self.DAYLIGHT_HOURS + 1, (n_days,),
                             generator=generator).tolist()

    def _window_generator(self, offset):
        """The CPU ``torch.Generator`` of a step's window draws: seeded
        with the step counter, one stream for the generator's loss
        (``offset`` 0) and one for the discriminator's (1)."""
        return torch.Generator().manual_seed(2 * self._step_counter + offset)

    def content_loss(self, out, hr, generator=None):
        """Centre-hours pointwise loss + daily-mean loss, averaged over
        the days."""
        sh, dh, plh = (self.STARTING_HOUR, self.DAYLIGHT_HOURS,
                       self.POINT_LOSS_HOURS)
        n_days = self._n_days(hr)
        content = 0.0
        for i in range(n_days):
            base = 24 * i
            p0 = base + (24 - plh) // 2
            content = content + apply_loss(
                self.loss_fun, out[:, :, :, p0:p0 + plh],
                hr[:, :, :, p0:p0 + plh], generator=generator)
            content = content + apply_loss(
                self.loss_fun, torch.mean(out[:, :, :, base:base + 24], 3),
                torch.mean(hr[:, :, :, base + sh:base + sh + dh], 3),
                generator=generator)
        return content / n_days

    # ------------------------------------------------------------------
    # the train step
    def _train_step(self, lr, hr, weight_gen_advers, do_gen, do_disc):
        """One gated step with the daylight-window losses (reference:
        solar_cc.py:46-158). The discriminator's loss draws its own
        windows of the generated output, as the JAX step does, and reads
        it without gradients to the generator."""
        self._step_counter += 1
        gen_params, disc_params = self.gen_params, self.disc_params
        gen_apply = self._maybe_remat(self._train_gen_net().apply)
        cast = self._train_cast()
        generator = self._loss_generator()
        n_days = self._n_days(hr)
        gather = self._gather
        with exact_fp32():
            with torch.set_grad_enabled(do_gen):
                out = gen_apply(cast(lr), {}).float()
            starts = self.draw_window_starts(n_days, out.shape[3],
                                             self._window_generator(0))
            with torch.set_grad_enabled(do_gen or do_disc):
                with torch.set_grad_enabled(do_disc):
                    d_true = gather(self._disc.apply(
                        cast(self.true_windows(hr))).float())
                d_gen = gather(self._disc.apply(cast(self.gen_windows(
                    out, starts))).float())
                content = self.content_loss(gather(out), gather(hr),
                                            generator=generator)
                advers = relativistic_disc_loss(d_gen, d_true)
                gen_loss = content + weight_gen_advers * advers
                disc_starts = self.draw_window_starts(
                    n_days, out.shape[3], self._window_generator(1))
                with torch.set_grad_enabled(do_disc):
                    d_gen_disc = gather(self._disc.apply(cast(
                        self.gen_windows(out.detach(), disc_starts))).float())
                    disc_loss = relativistic_disc_loss(d_true, d_gen_disc)
            if do_gen:
                gen_grads = self._reduce_grads(torch.autograd.grad(
                    gen_loss, gen_params, retain_graph=do_disc))
            if do_disc:
                disc_grads = self._reduce_grads(torch.autograd.grad(
                    disc_loss, disc_params))
            if do_gen:
                self._gen_tx.update(gen_params, gen_grads,
                                    self._gen_opt_state)
            if do_disc:
                self._disc_tx.update(disc_params, disc_grads,
                                     self._disc_opt_state)
        return {'loss_gen': gen_loss, 'loss_gen_content': content,
                'loss_gen_advers': advers, 'loss_disc': disc_loss}

    def _window_losses(self, hr, out, weight_gen_advers):
        """The losses on FIXED daylight windows of both samples (the
        deterministic counterpart of the train step's)."""
        d_true = self._disc.apply(self.true_windows(hr))
        d_gen = self._disc.apply(self.true_windows(out))
        content = self.content_loss(out, hr)
        advers = relativistic_disc_loss(d_gen, d_true)
        return {'loss_disc': relativistic_disc_loss(d_true, d_gen),
                'loss_gen': content + weight_gen_advers * advers,
                'loss_gen_content': content, 'loss_gen_advers': advers}

    def _val_step(self, lr, hr, weight_gen_advers):
        """Validation with the daylight-window losses on fixed windows of
        both samples, the generated output reflected to the true length
        first (reference: solar_cc.py:160-220); over the global batch
        (gathered) with a mesh attached."""
        self._n_days(hr)
        out = self._train_gen_net().apply(lr, self._split_exo(hr))
        out = reflect_pad_time(out, (hr.shape[3] - out.shape[3]) // 2)
        return self._window_losses(self._gather(hr), self._gather(out),
                                   weight_gen_advers)

    def calc_loss(self, hi_res_true, hi_res_gen, weight_gen_advers=0.001,
                  train_gen=True, train_disc=False, compute_disc=False):
        """Daylight-window losses of a (true, generated) HR pair on fixed
        windows (reference: solar_cc.py:222-261); returns (loss,
        details) as tensors on the model's device."""
        hr = self._place_batch(hi_res_true)
        out = self._place_batch(hi_res_gen)
        with torch.no_grad(), exact_fp32():
            losses = self._window_losses(hr, out, weight_gen_advers)
        details, loss = {}, None
        if compute_disc or train_disc:
            details['loss_disc'] = losses['loss_disc']
        if train_gen:
            details.update({k: losses[k] for k in (
                'loss_gen', 'loss_gen_content', 'loss_gen_advers')})
            loss = losses['loss_gen']
        elif train_disc:
            loss = details['loss_disc']
        return loss, details

    # ------------------------------------------------------------------
    # serving
    def temporal_pad(self, low_res, hi_res, mode='reflect'):
        """Reflect the output's time axis to t_in * t_enhance (reference:
        solar_cc.py:253-297); a tensor stays on its device."""
        if mode != 'reflect':
            raise ValueError(f'temporal_pad mode must be "reflect", got '
                             f'{mode!r}')
        t_shape = low_res.shape[-2] * self.t_enhance
        return reflect_pad_time(hi_res, int((t_shape - hi_res.shape[-2])
                                            / 2))

    def generate(self, low_res, norm_in=True, un_norm_out=True,
                 exogenous_data=None, fetch=True, mesh=None):
        """``Sup3rGan.generate``, then ``temporal_pad`` back to the full
        length (on the device when the output is a tensor)."""
        out = super().generate(low_res, norm_in=norm_in,
                               un_norm_out=un_norm_out,
                               exogenous_data=exogenous_data, fetch=False,
                               mesh=mesh)
        out = self.temporal_pad(low_res, out)
        if fetch and isinstance(out, torch.Tensor):
            return out.cpu().numpy()
        return out

    @classmethod
    def load(cls, model_dir, t_enhance=None, verbose=True,
             device='cuda'):
        """Load, with an optional ``t_enhance`` override (the serving
        factor of a chain: 24 on an 8x network)."""
        model = super().load(model_dir, device=device, verbose=verbose)
        if t_enhance is not None:
            model._t_enhance_override = t_enhance
            model.meta['t_enhance'] = t_enhance
        return model
