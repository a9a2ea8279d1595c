"""Sup3rGan, inference half: build, initialize or load the generator
and serve ``generate`` (the port of the inference half of
``sup3r_tpu/models/gan.py``).

The training step, its losses and optimizers come with the training
slice (ROADMAP queue 1 item 6); fast mode with the fast-mode item
(queue 1 item 3).
"""

import logging
import os

import numpy as np
import torch

from sup3r_tpu_torch.models.abstract import AbstractSingleModel
from sup3r_tpu_torch.models.fuse import FusedReflectConv, fuse_network
from sup3r_tpu_torch.models.network import Network
from sup3r_tpu_torch.models.weights import (
    load_jax_checkpoint,
    params_from_jax,
    params_to_jax,
    save_jax_checkpoint,
)
from sup3r_tpu_torch.utilities import exact_fp32, resolve_device

logger = logging.getLogger(__name__)

_FAST_MODE = ('fast mode and the subpixel tail come with a later slice of '
              'the port (ROADMAP queue 1 item 3: ops/subpixel.py and '
              'fuse_subpixel_tail)')


class Sup3rGan(AbstractSingleModel):
    """Super-resolving GAN, served in exact fp32."""

    def __init__(self, gen_layers, disc_layers, loss='MeanSquaredError',
                 meta=None, means=None, stdevs=None, name=None,
                 device='cuda'):
        """
        Parameters
        ----------
        gen_layers / disc_layers : list | dict | str
            ``hidden_layers`` config list (or a dict holding one), or
            path to a JSON file with a ``hidden_layers`` key.
        loss : str | dict | list
            Content loss spec, recorded in ``model_params`` for the
            training slice.
        device : str | torch.device
            Where the networks live and ``generate`` runs. A CUDA device
            with no card raises; pass ``'cpu'`` for the CPU.
        """
        super().__init__()
        self.device = resolve_device(device)
        self.name = name or self.__class__.__name__
        self._gen = self.load_network(gen_layers, 'generator')
        self._disc = self.load_network(disc_layers, 'discriminator')
        self._gen_config = self._gen.config
        self._disc_config = self._disc.config
        self.loss_name = loss
        self.meta = meta if meta is not None else {}
        self.set_norm_stats(means, stdevs)
        self._gen_in_shape = None
        self._disc_in_shape = None
        self._fused_cache_entries = []

    # ------------------------------------------------------------------
    # weights
    def init_weights(self, lr_shape, hr_shape, seed=None):
        """Initialize generator/discriminator params for the given
        channels-last input shapes, from a ``torch.Generator`` seeded
        with ``seed`` (42 by default). The draws differ from the JAX
        package's for the same seed; carry JAX weights across with
        ``params_from_jax`` / ``load``."""
        gen = torch.Generator().manual_seed(42 if seed is None else seed)
        gen_out = self._gen.init(lr_shape, gen)
        self._disc.init(hr_shape, gen)
        self._gen.to(self.device)
        self._disc.to(self.device)
        self._gen_in_shape = tuple(lr_shape)
        self._disc_in_shape = tuple(hr_shape)
        logger.debug('Initialized GAN weights: gen in %s -> out %s; disc '
                     'in %s', lr_shape, gen_out, hr_shape)

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
        """The fused generator Network; rebuilt when the generator's
        parameter tensors change identity or the flags change."""
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
        not modify it in place."""
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
        })
        return params

    def save(self, out_dir):
        """Save to a directory in the JAX package's layout:
        ``model_params.json`` plus the ``model_gen.msgpack`` /
        ``model_disc.msgpack`` weights in flax's format, so the JAX
        package's ``Sup3rGan.load`` reads it. Optimizer state and
        training history come with the training slice (the JAX load
        treats both as optional)."""
        os.makedirs(out_dir, exist_ok=True)
        if self.gen_params is not None:
            save_jax_checkpoint(params_to_jax(self._gen),
                                os.path.join(out_dir, 'model_gen.msgpack'))
            save_jax_checkpoint(params_to_jax(self._disc),
                                os.path.join(out_dir,
                                             'model_disc.msgpack'))
        self.save_params(out_dir)
        logger.info('Saved GAN to %s', out_dir)

    @classmethod
    def load(cls, model_dir, device='cuda', verbose=True):
        """Load a GAN that ``save`` here or the JAX package's
        ``Sup3rGan.save`` wrote: ``model_params.json`` plus the
        ``model_gen.msgpack`` / ``model_disc.msgpack`` weights."""
        params = cls.load_saved_params(model_dir, verbose=verbose)
        model = cls(
            params['gen_config'], params['disc_config'],
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
        return model
