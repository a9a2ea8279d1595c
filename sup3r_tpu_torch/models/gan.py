"""Sup3rGan: super-resolution GAN with a relativistic adversarial loss
(the port of ``sup3r_tpu/models/gan.py``): build, initialize, load and
save; serve ``generate``; and train.

The train step is one generator forward, both losses, both backward
passes and both gated optimizer updates, in exact fp32 (TF32 off for the
whole step, backward included):

- the generator runs fused (``train_fuse``): its HR tail launches the
  hand-written ``small_reflect_conv`` kernel on the card under autograd,
  its body convs run ``reflect_conv_ad`` (cuDNN with the custom
  backward);
- gen loss = content + ``weight_gen_advers`` * relativistic(d_gen,
  d_true); its gradients go to the generator's params through
  ``torch.autograd.grad``;
- the discriminator loss uses the same discriminator outputs, from the
  PRE-update discriminator params on the (value of the) generated
  output, as the JAX step's ``stop_gradient`` does;
- ``do_gen`` / ``do_disc`` gate the updates (optax's rules,
  ``models/optimizers.py``); the loss scalars come back either way, in
  one device-to-host copy.

Fast mode comes with the fast-mode item (queue 1 item 3); bf16 training,
``train_remat``, meshes and tensorboard logging with later items of the
training queue (ROADMAP).
"""

import logging
import os
import time

import numpy as np
import torch

from sup3r_tpu_torch.models.abstract import AbstractSingleModel
from sup3r_tpu_torch.models.fuse import FusedReflectConv, fuse_network
from sup3r_tpu_torch.models.network import Network
from sup3r_tpu_torch.models.optimizers import make_optimizer
from sup3r_tpu_torch.models.record import Record
from sup3r_tpu_torch.models.weights import (
    load_jax_checkpoint,
    opt_state_from_jax,
    opt_state_to_jax,
    packb,
    params_from_jax,
    params_to_jax,
    save_jax_checkpoint,
    unpackb,
)
from sup3r_tpu_torch.ops.coarsen import (
    spatial_coarsening,
    temporal_coarsening,
)
from sup3r_tpu_torch.ops.losses import apply_loss
from sup3r_tpu_torch.utilities import exact_fp32, resolve_device

logger = logging.getLogger(__name__)

_FAST_MODE = ('fast mode and the subpixel tail come with a later slice of '
              'the port (ROADMAP queue 1 item 3: ops/subpixel.py and '
              'fuse_subpixel_tail)')


def _not_ported(what, item):
    return NotImplementedError(
        f'{what} is not ported yet: ROADMAP queue 1 item 6, {item}')


def _sigmoid_bce(logits, labels):
    """Numerically-stable sigmoid cross entropy (tf.nn semantics)."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def relativistic_disc_loss(disc_out_true, disc_out_gen):
    """ESRGAN relativistic average discriminator loss. Swap the
    arguments to get the generator's adversarial loss."""
    true_logits = disc_out_true - torch.mean(disc_out_gen)
    fake_logits = disc_out_gen - torch.mean(disc_out_true)
    logits = torch.cat([true_logits, fake_logits], dim=0)
    labels = torch.cat([torch.ones_like(disc_out_true),
                        torch.zeros_like(disc_out_gen)], dim=0)
    return torch.mean(_sigmoid_bce(logits, labels))


class Sup3rGan(AbstractSingleModel):
    """Super-resolving GAN, served and trained in exact fp32."""

    def __init__(self, gen_layers, disc_layers, optimizer=None,
                 learning_rate=1e-4, optimizer_disc=None,
                 learning_rate_disc=None, loss='MeanSquaredError',
                 meta=None, means=None, stdevs=None, name=None,
                 device='cuda'):
        """
        Parameters
        ----------
        gen_layers / disc_layers : list | dict | str
            ``hidden_layers`` config list (or a dict holding one), or
            path to a JSON file with a ``hidden_layers`` key.
        optimizer / optimizer_disc : dict | None
            Optimizer configs like ``{'name': 'Adam', 'learning_rate':
            1e-4}`` (``models/optimizers.py``); ``learning_rate(_disc)``
            shortcuts as in the JAX package.
        loss : str | dict | list
            Content loss spec resolved by
            :func:`sup3r_tpu_torch.ops.losses.get_loss_fun`.
        device : str | torch.device
            Where the networks live, train and serve. A CUDA device with
            no card raises; pass ``'cpu'`` for the CPU.
        """
        super().__init__()
        self.device = resolve_device(device)
        self.name = name or self.__class__.__name__
        self._gen = self.load_network(gen_layers, 'generator')
        self._disc = self.load_network(disc_layers, 'discriminator')
        self._gen_config = self._gen.config
        self._disc_config = self._disc.config

        if optimizer is None:
            optimizer = {'name': 'Adam', 'learning_rate': learning_rate}
        if optimizer_disc is None:
            optimizer_disc = dict(optimizer)
            if learning_rate_disc is not None:
                optimizer_disc['learning_rate'] = learning_rate_disc
        self._gen_tx, self._optimizer_config = make_optimizer(optimizer)
        self._disc_tx, self._optimizer_disc_config = make_optimizer(
            optimizer_disc)

        self.set_loss_function(loss)
        self.meta = meta if meta is not None else {}
        self.set_norm_stats(means, stdevs)
        self._gen_opt_state = None
        self._disc_opt_state = None
        self._gen_in_shape = None
        self._disc_in_shape = None
        self._init_seed = 42
        self._fused_cache_entries = []
        self._train_net = None
        self._train_record = None
        self._sample_transform = None
        self._step_counter = 0
        self.total_batches = 0

    # ------------------------------------------------------------------
    # weights
    def init_weights(self, lr_shape, hr_shape, seed=None):
        """Initialize generator/discriminator params and optimizer state
        for the given channels-last input shapes, from a
        ``torch.Generator`` seeded with ``seed`` (42 by default). As in
        the JAX package, a repeated call is a no-op unless ``seed`` is
        given or the input channels change. The draws differ from the
        JAX package's for the same seed; carry JAX weights across with
        ``params_from_jax`` / ``load``."""
        if seed is not None:
            self._init_seed = seed
        if not (seed is not None or self.gen_params is None
                or lr_shape[-1] != self._gen_in_shape[-1]):
            return
        gen = torch.Generator().manual_seed(self._init_seed)
        gen_out = self._gen.init(lr_shape, gen)
        self._disc.init(hr_shape, gen)
        self._gen.to(self.device)
        self._disc.to(self.device)
        self._gen_in_shape = tuple(lr_shape)
        self._disc_in_shape = tuple(hr_shape)
        self._set_trainable()
        self._gen_opt_state = self._gen_tx.init(self.gen_params)
        self._disc_opt_state = self._disc_tx.init(self.disc_params)
        logger.debug('Initialized GAN weights: gen in %s -> out %s; disc '
                     'in %s', lr_shape, gen_out, hr_shape)

    def _set_trainable(self):
        """Turn gradients on for both networks' params (the layers make
        them frozen, for serving)."""
        for p in (*self._gen.parameters(), *self._disc.parameters()):
            p.requires_grad_(True)

    @property
    def generator(self):
        """Generator Network module."""
        return self._gen

    @property
    def discriminator(self):
        """Discriminator Network module."""
        return self._disc

    @property
    def gen_params(self):
        """The generator's parameter tensors, in layer order (None
        before the weights exist)."""
        if self._gen_in_shape is None:
            return None
        return tuple(self._gen.parameters())

    @property
    def disc_params(self):
        """The discriminator's parameter tensors, in layer order (None
        before the weights exist)."""
        if self._disc_in_shape is None:
            return None
        return tuple(self._disc.parameters())

    # ------------------------------------------------------------------
    # the train step
    def _check_train_options(self):
        if self.train_dtype is not None:
            raise _not_ported(f'train_dtype={self.train_dtype!r}',
                              'bf16 training')
        if self.train_remat:
            raise _not_ported('train_remat', 'gradient rematerialization')
        if self.train_shard_aligned:
            raise NotImplementedError(
                'train_shard_aligned comes with the multi-device slice '
                '(ROADMAP queue 1 item 9)')

    def _train_gen_net(self):
        """The generator network the train step runs: fused (see
        ``train_fuse``), its blocks reading the generator's own
        params."""
        if not self.train_fuse:
            return self._gen
        if self._train_net is None:
            self._train_net = Network(fuse_network(list(self._gen.layers)))
        return self._train_net

    def _split_exo(self, hr):
        """The exo channels of a training HR batch, by feature."""
        n_exo = len(self.hr_exo_features)
        n_out = hr.shape[-1] - n_exo
        return {f: hr[..., n_out + i:n_out + i + 1]
                for i, f in enumerate(self.hr_exo_features)}

    def _loss_generator(self):
        """A ``torch.Generator`` for losses that draw random numbers,
        seeded with the step counter (None for the others)."""
        if not getattr(self.loss_fun, 'needs_generator', False):
            return None
        return torch.Generator(device=self.device).manual_seed(
            self._step_counter)

    def _train_step(self, lr, hr, weight_gen_advers, do_gen, do_disc):
        """One gated step on device tensors; returns the loss scalars
        (device tensors)."""
        self._check_train_options()
        self._step_counter += 1
        gen_params, disc_params = self.gen_params, self.disc_params
        net = self._train_gen_net()
        names = self.hr_exo_features
        slc = slice(0, -len(names)) if names else slice(None)
        generator = self._loss_generator()
        with exact_fp32():
            exo = self._split_exo(hr)
            with torch.set_grad_enabled(do_gen):
                out = net.apply(lr, exo)
            full = (torch.cat([out] + [exo[f] for f in names], dim=-1)
                    if names else out)
            with torch.set_grad_enabled(do_gen or do_disc):
                with torch.set_grad_enabled(do_disc):
                    d_true = self._disc.apply(hr)
                d_gen = self._disc.apply(full)
                content = apply_loss(self.loss_fun, out, hr[..., slc],
                                     generator=generator)
                advers = relativistic_disc_loss(d_gen, d_true)
                gen_loss = content + weight_gen_advers * advers
                # the discriminator's loss reads the same outputs: its
                # pre-update params on the generated output's value
                disc_loss = relativistic_disc_loss(d_true, d_gen)
            if do_gen:
                gen_grads = torch.autograd.grad(gen_loss, gen_params,
                                                retain_graph=do_disc)
            if do_disc:
                disc_grads = torch.autograd.grad(disc_loss, disc_params)
            if do_gen:
                self._gen_tx.update(gen_params, gen_grads,
                                    self._gen_opt_state)
            if do_disc:
                self._disc_tx.update(disc_params, disc_grads,
                                     self._disc_opt_state)
        return {'loss_gen': gen_loss, 'loss_gen_content': content,
                'loss_gen_advers': advers, 'loss_disc': disc_loss}

    def _place_batch(self, arr):
        """A float32 tensor on the model's device (no copy for one that
        is there already)."""
        return torch.as_tensor(arr, dtype=torch.float32, device=self.device)

    def run_gradient_descent(self, low_res, hi_res_true,
                             weight_gen_advers=0.001, train_gen=True,
                             train_disc=False):
        """One gated optimization step on a (lr, hr) batch pair;
        ``train_gen`` / ``train_disc`` gate which updates apply. Returns
        the loss scalars."""
        details = self._train_step(
            self._place_batch(low_res), self._place_batch(hi_res_true),
            float(weight_gen_advers), bool(train_gen), bool(train_disc))
        return self._fetch_details(details)

    def _split_sample(self, sample):
        """Device-side HR->LR transform of a raw sample batch with the
        batch handler's transform config."""
        cfg = self._sample_transform
        lr = spatial_coarsening(sample, cfg['s_enhance'])
        if cfg['t_enhance'] > 1:
            lr = temporal_coarsening(lr, cfg['t_enhance'], cfg['method'])
        hr = sample[..., list(cfg['hr_features_ind'])]
        if cfg['squeeze_time']:
            lr = lr[:, :, :, 0, :]
            hr = hr[:, :, :, 0, :]
        return lr, hr

    def run_gradient_descent_on_sample(self, sample,
                                       weight_gen_advers=0.001,
                                       train_gen=True, train_disc=False):
        """One gated step from a raw HR sample batch: the coarsening to
        the LR input runs on the device (set by ``train`` from a
        ``device_transform`` batch handler)."""
        lr, hr = self._split_sample(self._place_batch(sample))
        details = self._train_step(lr, hr, float(weight_gen_advers),
                                   bool(train_gen), bool(train_disc))
        return self._fetch_details(details)

    @staticmethod
    def _fetch_details(details):
        """Loss scalars to the host in ONE copy (a stacked tensor), not
        one per scalar."""
        keys = list(details)
        vals = torch.stack([details[k].detach() for k in keys]).cpu()
        return {k: float(v) for k, v in zip(keys, vals.tolist())}

    def update_optimizer(self, option='generator', **kwargs):
        """Update an optimizer's config (e.g. learning_rate) mid-training;
        its state (Adam's moments and count) is kept."""
        if option in ('generator', 'all'):
            self._gen_tx, self._optimizer_config = make_optimizer(
                {**self._optimizer_config, **kwargs})
        if option in ('discriminator', 'all'):
            self._disc_tx, self._optimizer_disc_config = make_optimizer(
                {**self._optimizer_disc_config, **kwargs})

    def attach_mesh(self, mesh, axis='data', spatial_axis=None):
        """Data-parallel and spatially sharded training come with the
        multi-device slice."""
        raise NotImplementedError(
            'attach_mesh comes with the multi-device slice of the port '
            '(ROADMAP queue 1 item 9)')

    # ------------------------------------------------------------------
    # inference
    #: rewrite FlexiblePadding(3)/Conv/Cropping(2) blocks into
    #: reflect-pad-1 + valid-conv for generate() — the configs compute a
    #: halo ring that is immediately cropped
    inference_fuse = True
    #: route every fused block the small kernel does not take to the
    #: hand-written ``reflect_conv`` CUDA kernel (opt-in)
    inference_pallas = False
    #: fast mode's subpixel tail: not ported yet, raises in generate()
    inference_subpixel_tail = False

    @property
    def inference_mode(self):
        """Named inference profile. The port serves ``'exact'`` (fp32
        body with TF32 off, exact-fp32 small-channel tail); ``'fast'``
        is not ported yet."""
        return 'exact'

    @inference_mode.setter
    def inference_mode(self, mode):
        if mode == 'fast':
            raise NotImplementedError(_FAST_MODE)
        if mode != 'exact':
            raise ValueError(
                f'inference_mode must be "exact" or "fast", got {mode!r}')

    def _get_fused_apply(self):
        """The fused generator Network for serving; rebuilt when the
        generator's parameter tensors change identity or the flags
        change."""
        params = self.gen_params
        flags = (self.inference_pallas,)
        # entries hold STRONG references to the params and compare
        # identity — an id() key could collide after the old tensors are
        # freed; entries for params that are no longer live are dropped
        entries = self._fused_cache_entries
        entries[:] = [e for e in entries if len(e[0]) == len(params)
                      and all(a is b for a, b in zip(e[0], params))]
        cached = next((e for e in entries if e[1] == flags), None)
        if cached is None:
            layers = fuse_network(list(self._gen.layers))
            for lyr in layers:
                if isinstance(lyr, FusedReflectConv):
                    lyr.use_pallas = self.inference_pallas
            cached = (params, flags, Network(layers))
            entries.append(cached)
        return cached[2]

    def _exo_for_generate(self, exogenous_data):
        """{feature: float32 tensor on the device} of mid-network
        ('layer') rasters from a plain ``{feature: array}`` dict."""
        if not exogenous_data:
            return {}
        return {k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=self.device)
                for k, v in exogenous_data.items()}

    def _norm_layer_exo(self, exo):
        """Normalize mid-network exo rasters with their own feature
        stats (training concatenates NORMALIZED exo channels, so
        inference must feed the layers the same scale)."""
        if self._means is None:
            return exo
        out = {}
        for k, v in exo.items():
            if k in self._means:
                v = (v - self._means[k]) / (self._stdevs[k] or 1.0)
            out[k] = v
        return out

    def generate(self, low_res, norm_in=True, un_norm_out=True,
                 exogenous_data=None, fetch=True):
        """Public inference: normalize -> generator (+layer exo) ->
        denormalize, in exact fp32 on ``self.device``.

        low_res: 4D/5D channels-last physical-units array (n_obs
        first), numpy or tensor. Returns a channels-last numpy array;
        with ``fetch=False`` the output tensor on ``self.device``
        instead, without waiting for the device (the forward pass
        crops and drains it while the next batch is dispatched). That
        tensor was made under ``torch.inference_mode``: slice it, do
        not modify it in place, and keep it out of training."""
        if self.inference_subpixel_tail:
            raise NotImplementedError(_FAST_MODE)
        low_res = torch.as_tensor(low_res, dtype=torch.float32,
                                  device=self.device)
        low_res = self._combine_fwp_input(low_res, exogenous_data)
        exo = self._exo_for_generate(exogenous_data)
        if norm_in and self._means is not None:
            low_res = self.norm_input(low_res)
            exo = self._norm_layer_exo(exo)
        if self.gen_params is None:
            self.init_weights(tuple(low_res.shape),
                              self._dummy_hr_shape(tuple(low_res.shape)))
        for f in self._gen.exo_features:
            if f not in exo:
                raise KeyError(
                    f'Model requires exogenous feature "{f}" passed via '
                    f'exogenous_data; got {sorted(exo)}')
        # exo arrays need a batch dim matching low_res
        fixed_exo = {}
        for k, v in exo.items():
            if v.ndim == low_res.ndim - 1:
                # a trailing singleton marks an unbatched raster WITH its
                # channel dim — even when its first spatial dim happens
                # to equal the batch size
                if v.shape[-1] == 1 or v.shape[0] != low_res.shape[0]:
                    v = v[None]
                else:
                    v = v[..., None]
            fixed_exo[k] = v
        net = self._get_fused_apply() if self.inference_fuse else self._gen
        un_norm = self.un_norm_tensors(self.device) if un_norm_out else None
        with torch.inference_mode(), exact_fp32():
            out = net.apply(low_res, fixed_exo)
            if un_norm is not None:
                out = out * un_norm[0] + un_norm[1]
        if not fetch:
            return out
        return self._combine_fwp_output(out.cpu().numpy(), exogenous_data)

    def _dummy_hr_shape(self, lr_shape):
        s, t = self._gen.s_enhance, self._gen.t_enhance
        n_out = self._gen.out_shape(lr_shape)[-1]
        n_hr = n_out + len(self.hr_exo_features)
        if len(lr_shape) == 5:
            return (lr_shape[0], lr_shape[1] * s, lr_shape[2] * s,
                    lr_shape[3] * t, n_hr)
        return (lr_shape[0], lr_shape[1] * s, lr_shape[2] * s, n_hr)

    # ------------------------------------------------------------------
    # save / load
    @property
    def model_params(self):
        params = super().model_params
        params.update({
            'gen_config': self._gen_config,
            'disc_config': self._disc_config,
            'gen_in_shape': self._gen_in_shape,
            'disc_in_shape': self._disc_in_shape,
            'optimizer': self._optimizer_config,
            'optimizer_disc': self._optimizer_disc_config,
        })
        return params

    def save(self, out_dir):
        """Save to a directory in the JAX package's layout:
        ``model_params.json``, the ``model_gen.msgpack`` /
        ``model_disc.msgpack`` weights and ``opt_state.msgpack`` in
        flax's format, and ``history.csv``, so the JAX package's
        ``Sup3rGan.load`` reads it and resumes."""
        os.makedirs(out_dir, exist_ok=True)
        if self.gen_params is not None:
            save_jax_checkpoint(params_to_jax(self._gen),
                                os.path.join(out_dir, 'model_gen.msgpack'))
            save_jax_checkpoint(params_to_jax(self._disc),
                                os.path.join(out_dir,
                                             'model_disc.msgpack'))
            state = {'0': opt_state_to_jax(self._gen_tx,
                                           self._gen_opt_state, self._gen),
                     '1': opt_state_to_jax(self._disc_tx,
                                           self._disc_opt_state,
                                           self._disc)}
            with open(os.path.join(out_dir, 'opt_state.msgpack'),
                      'wb') as f:
                f.write(packb(state))
        self.save_params(out_dir)
        self.save_history(out_dir)
        logger.info('Saved GAN to %s', out_dir)

    @classmethod
    def load(cls, model_dir, device='cuda', verbose=True):
        """Load a GAN that ``save`` here or the JAX package's
        ``Sup3rGan.save`` wrote: ``model_params.json``, the weights, and
        ``opt_state.msgpack`` / ``history.csv`` where present."""
        params = cls.load_saved_params(model_dir, verbose=verbose)
        model = cls(
            params['gen_config'], params['disc_config'],
            optimizer=params.get('optimizer'),
            optimizer_disc=params.get('optimizer_disc'),
            loss=params.get('loss', 'MeanSquaredError'),
            meta=params.get('meta', {}),
            means=params.get('means'), stdevs=params.get('stdevs'),
            device=device)
        gen_in = params.get('gen_in_shape')
        disc_in = params.get('disc_in_shape')
        if gen_in is not None:
            model.init_weights(tuple(gen_in), tuple(disc_in))
            params_from_jax(model._gen, load_jax_checkpoint(
                os.path.join(model_dir, 'model_gen.msgpack')))
            params_from_jax(model._disc, load_jax_checkpoint(
                os.path.join(model_dir, 'model_disc.msgpack')))
            fp_opt = os.path.join(model_dir, 'opt_state.msgpack')
            if os.path.exists(fp_opt):
                with open(fp_opt, 'rb') as f:
                    tree = unpackb(f.read())
                model._gen_opt_state = opt_state_from_jax(
                    model._gen_tx, tree['0'], model._gen)
                model._disc_opt_state = opt_state_from_jax(
                    model._disc_tx, tree['1'], model._disc)
        fp_history = os.path.join(model_dir, 'history.csv')
        if os.path.exists(fp_history):
            model._history = Record.read_csv(fp_history)
        return model

    # ------------------------------------------------------------------
    # training loop
    @staticmethod
    def get_weight_update_fraction(history, comparison_key,
                                   update_bounds=(0.5, 0.95),
                                   update_frac=0.0):
        """Multiplier for the adversarial weight based on how often the
        disc trained last epoch."""
        val = history[comparison_key]
        if isinstance(val, (list, tuple, np.ndarray)):
            val = np.asarray(val).ravel()[-1]
        if val < update_bounds[0]:
            return 1 + update_frac
        if val > update_bounds[1]:
            return 1 / (1 + update_frac)
        return 1

    def update_adversarial_weights(self, history, adaptive_update_fraction,
                                   adaptive_update_bounds,
                                   weight_gen_advers, train_disc):
        """Adapt the adversarial weight from disc training frequency."""
        if adaptive_update_fraction > 0 and train_disc:
            frac = self.get_weight_update_fraction(
                history, 'train_disc_train_frac',
                update_frac=adaptive_update_fraction,
                update_bounds=adaptive_update_bounds)
            weight_gen_advers *= frac
            if frac != 1:
                logger.debug('New adversarial weight: %.4e',
                             weight_gen_advers)
        return weight_gen_advers

    @staticmethod
    def check_batch_handler_attrs(batch_handler):
        """Pull optional metadata attrs off a batch handler."""
        return {
            k: getattr(batch_handler, k, None)
            for k in ['smoothing', 'lr_features', 'hr_exo_features',
                      'hr_out_features', 'smoothed_features']
            if hasattr(batch_handler, k)
        }

    def _train_batch(self, batch, train_gen, only_gen, gen_too_good,
                     train_disc, only_disc, disc_too_good,
                     weight_gen_advers):
        """Gated updates for one batch."""
        do_gen = bool(only_gen or (train_gen and not gen_too_good))
        do_disc = bool(only_disc or (train_disc and not disc_too_good))
        if hasattr(batch, 'sample'):
            details = self.run_gradient_descent_on_sample(
                batch.sample, weight_gen_advers=weight_gen_advers,
                train_gen=do_gen, train_disc=do_disc)
        else:
            details = self.run_gradient_descent(
                batch.low_res, batch.high_res,
                weight_gen_advers=weight_gen_advers,
                train_gen=do_gen, train_disc=do_disc)
        details['gen_train_frac'] = float(do_gen)
        details['disc_train_frac'] = float(do_disc)
        return details

    def _train_epoch(self, batch_handler, weight_gen_advers, train_gen,
                     train_disc, disc_loss_bounds):
        """One epoch with loss-bound disc/gen gating."""
        disc_th_low = np.min(disc_loss_bounds)
        disc_th_high = np.max(disc_loss_bounds)
        only_gen = train_gen and not train_disc
        only_disc = train_disc and not train_gen

        loss_disc_mean = 0.0
        if (self._train_record is not None
                and 'train_loss_disc' in self._train_record):
            loss_disc_mean = float(
                self._train_record['train_loss_disc'].mean())

        n_batches = len(batch_handler)
        for ib, batch in enumerate(batch_handler):
            t0 = time.time()
            disc_too_good = loss_disc_mean <= disc_th_low
            disc_too_bad = (loss_disc_mean > disc_th_high) and train_disc
            gen_too_good = disc_too_bad

            details = self._train_batch(
                batch, train_gen, only_gen, gen_too_good, train_disc,
                only_disc, disc_too_good, weight_gen_advers)
            self._train_record = self.update_loss_details(
                self._train_record, details, prefix='train_',
                max_batches=n_batches)
            loss_disc_mean = float(
                self._train_record['train_loss_disc'].mean())
            logger.debug(
                'Batch %d/%d gen %.3e disc %.3e (%.3fs)', ib + 1,
                n_batches, details['loss_gen'], details['loss_disc'],
                time.time() - t0)
        self.total_batches += n_batches
        out = self._train_record.mean()
        out['total_batches'] = int(self.total_batches)
        return out

    def _val_step(self, lr, hr, weight_gen_advers):
        """The losses of one validation batch (no gradients)."""
        names = self.hr_exo_features
        slc = slice(0, -len(names)) if names else slice(None)
        net = self._train_gen_net()
        out = net.apply(lr, self._split_exo(hr))
        full = self._combine_loss_input(hr, out)
        d_true = self._disc.apply(hr)
        d_gen = self._disc.apply(full)
        content = apply_loss(self.loss_fun, full[..., slc], hr[..., slc])
        advers = relativistic_disc_loss(d_gen, d_true)
        return {'loss_disc': relativistic_disc_loss(d_true, d_gen),
                'loss_gen': content + weight_gen_advers * advers,
                'loss_gen_content': content,
                'loss_gen_advers': advers}

    def calc_val_loss(self, batch_handler, weight_gen_advers):
        """Mean validation losses over the val queue."""
        val_data = getattr(batch_handler, 'val_data', None)
        if val_data is None or (hasattr(val_data, '__len__')
                                and len(val_data) == 0):
            return {}
        record = None
        with torch.no_grad(), exact_fp32():
            for batch in val_data:
                if hasattr(batch, 'sample'):
                    lr, hr = self._split_sample(
                        self._place_batch(batch.sample))
                else:
                    lr = self._place_batch(batch.low_res)
                    hr = self._place_batch(batch.high_res)
                details = self._val_step(lr, hr, float(weight_gen_advers))
                record = self.update_loss_details(
                    record, self._fetch_details(details), prefix='val_')
        return record.mean() if record is not None else {}

    def train(self, batch_handler, input_resolution, n_epoch,
              weight_gen_advers=0.001, train_gen=True, train_disc=True,
              disc_loss_bounds=(0.45, 0.6), checkpoint_int=None,
              out_dir='./gan_{epoch}', early_stop_on=None,
              early_stop_threshold=0.005, early_stop_n_epoch=5,
              adaptive_update_bounds=(0.9, 0.99),
              adaptive_update_fraction=0.0, multi_gpu=False,
              tensorboard_log=False, tensorboard_profile=False):
        """Train the GAN over a batch handler's epochs of batches, with
        validation, history, early stopping and checkpoints.

        ``multi_gpu`` is accepted for API parity, as in the JAX package.
        The batch handler stages its batches on this model's device
        (its ``device``, set here when it has none)."""
        if tensorboard_log or tensorboard_profile:
            raise _not_ported('tensorboard logging and profiling',
                              'tensorboard')
        self.set_norm_stats(batch_handler.means, batch_handler.stds)
        params = self.check_batch_handler_attrs(batch_handler)
        self.set_model_params(
            input_resolution=input_resolution,
            s_enhance=batch_handler.s_enhance,
            t_enhance=batch_handler.t_enhance, **params)
        transform_config = getattr(batch_handler, 'transform_config',
                                   None)
        if transform_config is not None:
            self._sample_transform = transform_config
        if getattr(batch_handler, 'device', None) is None:
            batch_handler.device = self.device

        lr_shape = (1, *batch_handler.lr_shape)
        hr_shape = (1, *batch_handler.hr_shape)
        self.init_weights(lr_shape, hr_shape)

        epochs = list(range(n_epoch))
        if self._history is None:
            self._history = Record()
        else:
            epochs = [e + len(self._history) for e in epochs]

        t0 = time.time()
        stop = False
        try:
            for epoch in epochs:
                loss_details = self._train_epoch(
                    batch_handler, weight_gen_advers, train_gen,
                    train_disc, disc_loss_bounds)
                loss_details.update(self.calc_val_loss(batch_handler,
                                                       weight_gen_advers))
                logger.info(
                    'Epoch %d gen loss %.3e disc loss %.3e', epoch,
                    loss_details.get('train_loss_gen', np.nan),
                    loss_details.get('train_loss_disc', np.nan))

                extras = {
                    'weight_gen_advers': weight_gen_advers,
                    'disc_loss_bound_0': disc_loss_bounds[0],
                    'disc_loss_bound_1': disc_loss_bounds[1],
                    'learning_rate_gen':
                        self._optimizer_config['learning_rate'],
                    'learning_rate_disc':
                        self._optimizer_disc_config['learning_rate'],
                    'train_gen': int(train_gen),
                    'train_disc': int(train_disc),
                }
                weight_gen_advers = self.update_adversarial_weights(
                    loss_details, adaptive_update_fraction,
                    adaptive_update_bounds, weight_gen_advers, train_disc)
                self._history.append({'elapsed_time': time.time() - t0,
                                      **loss_details, **extras},
                                     index=epoch)

                if early_stop_on is not None and (
                        early_stop_on in self._history):
                    stop = self.early_stop(
                        self._history, early_stop_on,
                        threshold=early_stop_threshold,
                        n_epoch=early_stop_n_epoch)
                save_now = (
                    stop or epoch == epochs[-1]
                    or (checkpoint_int is not None
                        and (epoch % checkpoint_int) == 0))
                if save_now and out_dir is not None:
                    self.save(out_dir.format(epoch=epoch))
                if stop:
                    break
        finally:
            if hasattr(batch_handler, 'stop'):
                batch_handler.stop()
