"""Sup3rGan: super-resolution GAN with a relativistic adversarial loss
(the port of ``sup3r_tpu/models/gan.py``): build, initialize, load and
save; serve ``generate``; and train.

The train step is one generator forward, both losses, both backward
passes and both gated optimizer updates, in exact fp32 (TF32 off for the
whole step, backward included):

- the generator runs fused (``train_fuse``): its HR tail launches the
  hand-written ``small_reflect_conv`` kernel on the card under autograd,
  its body convs run ``reflect_conv_ad`` (cuDNN with the custom
  backward); every fp32 fused 3D block's weight gradient runs on the
  hand-written ``reflect_conv_wgrad`` kernel on the card where it was
  timed faster (``ops/kernels.py::wgrad_kernel_wins``);
- gen loss = content + ``weight_gen_advers`` * relativistic(d_gen,
  d_true); its gradients go to the generator's params through
  ``torch.autograd.grad``;
- the discriminator loss uses the same discriminator outputs, from the
  PRE-update discriminator params on the (value of the) generated
  output, as the JAX step's ``stop_gradient`` does;
- ``do_gen`` / ``do_disc`` gate the updates (optax's rules,
  ``models/optimizers.py``); the loss scalars come back either way, in
  one device-to-host copy.

``train_dtype='bfloat16'`` runs both networks in bf16 (inputs cast at
the network boundary, each layer's params cast to its input's dtype, the
outputs cast back to float32 before the losses), so losses, gradients at
the boundary, master weights and optimizer state stay float32;
``train_remat`` recomputes the generator's forward in the backward
(``torch.utils.checkpoint``).

Serving has two named modes (``inference_mode``): 'exact' (float32, TF32
off, the HR tail on ``small_reflect_conv``) and 'fast' (the subpixel tail
and a bf16 body on cuDNN's bf16 convs, the output cast back to float32).

``train(tensorboard_log=True)`` writes each epoch's history row as
tensorboard scalars and ``tensorboard_profile=True`` records the first
epoch with ``torch.profiler`` (``models/utilities.py``).

``attach_mesh`` makes the step data parallel over a mesh of ranks
(``sup3r_tpu_torch.parallel``): each rank runs both networks on its own
rows; the discriminator outputs, the generated and true HR batches (and
a subclass's loss state) are gathered, so every rank computes the
global batch's losses, exactly as one device would (the relativistic
loss subtracts batch means and a content loss like ``mmd_loss`` pairs
every sample with every other); a rank's dropout masks are its rows of
the global batch's (``Dropout``); the gradients are summed over the
ranks (one flat all-reduce per network) before the identical updates.
On a dp x sp mesh (``parallel.get_mesh_2d``) each rank also holds a
block of each sample's s1 rows: both networks run on the block
(``models/layers.py`` lists the sharded forms; every exchange between
ranks is differentiable), the generated and true HR blocks are gathered
over ``space`` before the batch rows, and the gradients of the params
a ``space`` group computes whole (the discriminator's head) are summed
over ``data`` only (``_reduce_grads``).
``generate(..., mesh=...)`` serves a block of s1 rows of a spatially
sharded input.
"""

import logging
import os
import time

import numpy as np
import torch

from sup3r_tpu_torch.models.abstract import (
    AbstractSingleModel,
    compute_dtype,
)
from sup3r_tpu_torch.models.fuse import (
    FusedReflectConv,
    fuse_network,
    fuse_subpixel_tail,
)
from sup3r_tpu_torch.models.network import Network
from sup3r_tpu_torch.models.optimizers import make_optimizer
from sup3r_tpu_torch.models.weights import (
    opt_state_from_jax,
    opt_state_to_jax,
)
from sup3r_tpu_torch.names import strip_obs_suffix
from sup3r_tpu_torch.ops.coarsen import (
    spatial_coarsening,
    temporal_coarsening,
)
from sup3r_tpu_torch.ops.losses import apply_loss
from sup3r_tpu_torch.parallel.mesh import (
    SpatialShard,
    all_gather_object,
    replicate,
    shard_spatial,
)
from sup3r_tpu_torch.utilities import exact_fp32, resolve_device, trace

logger = logging.getLogger(__name__)

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
        if self._mesh is not None:
            self._replicate()
        logger.debug('Initialized GAN weights: gen in %s -> out %s; disc '
                     'in %s', lr_shape, gen_out, hr_shape)

    def _set_trainable(self):
        """Turn gradients on for both networks' params (the layers make
        them frozen, for serving)."""
        for p in (*self._gen.parameters(), *self._disc.parameters()):
            p.requires_grad_(True)

    @property
    def discriminator(self):
        """Discriminator Network module."""
        return self._disc

    @property
    def disc_params(self):
        """The discriminator's parameter tensors, in layer order (None
        before the weights exist)."""
        if self._disc_in_shape is None:
            return None
        return tuple(self._disc.parameters())

    @property
    def generator_weights(self):
        """The generator's parameter tensors (``gen_params``)."""
        return self.gen_params

    @property
    def discriminator_weights(self):
        """The discriminator's parameter tensors (``disc_params``)."""
        return self.disc_params

    @property
    def weights(self):
        """All trainable params: {'generator': ..., 'discriminator':
        ...}."""
        return {'generator': self.gen_params,
                'discriminator': self.disc_params}

    # ------------------------------------------------------------------
    # the train step
    #: why the class's train step cannot run on a ``space`` axis (None:
    #: it can)
    _spatial_refusal = None

    def _loss_generator(self):
        """A ``torch.Generator`` for losses that draw random numbers,
        seeded with the step counter (None for the others)."""
        if not getattr(self.loss_fun, 'needs_generator', False):
            return None
        return torch.Generator(device=self.device).manual_seed(
            self._step_counter)

    def _dropout_kwargs(self, network, offset):
        """The ``apply`` kwargs that turn a network's ``Dropout`` layers
        on in a train step: a generator on the model's device seeded with
        the step counter, one stream per network call (``offset``), and
        with a mesh attached this rank's rows of the global batch's masks
        (and on a ``space`` axis its block of their s1 rows: ``Dropout``);
        none for a network without dropout."""
        if not network.has_dropout:
            return {}
        seed = 4 * self._step_counter + offset
        kwargs = {'train': True, 'dropout_generator': torch.Generator(
            device=self.device).manual_seed(seed)}
        if self._mesh is not None:
            kwargs['dropout_rows'] = (
                self._mesh.axis_index(self._mesh_axis),
                self._mesh.shape[self._mesh_axis])
        return kwargs

    def _train_exo(self, hr):
        """(exo rasters for the generator, state for
        ``_extra_gen_loss``) of a training HR batch: the exo channels by
        feature; subclasses add observation rasters."""
        return self._split_exo(hr), None

    def _gather_disc(self):
        """The gather of the discriminator's outputs: over the batch axis
        after a Flatten -> Dense head (whole on every rank of a ``space``
        group), else (a fully convolutional D's blocks) as HR tensors."""
        return self._gather if self._disc.whole_on_space else self._gather_hr

    def _layer_exo(self, exo):
        """The generator's exo rasters of a step: on a ``space`` axis the
        HR batch's exo channels are the rank's block, and an exo layer
        takes its rows of a full-size raster, so they are gathered over
        ``space`` first."""
        if self._mesh_spatial_axis is None:
            return exo
        return {k: self._gather_space(v) for k, v in exo.items()}

    def _extra_gen_loss(self, out, hr, state):
        """(term added to the content loss, extra loss details) of a
        train step; none for a plain GAN."""
        return 0.0, {}

    def _train_step(self, lr, hr, weight_gen_advers, do_gen, do_disc):
        """One gated step on device tensors; returns the loss scalars
        (device tensors). With ``train_dtype`` both networks run in it:
        their inputs are cast here, their params in each layer, and
        their outputs come back to float32 before the exo concat and
        the losses. A network with ``Dropout`` draws its masks from a
        generator seeded with the step counter; then the discriminator's
        loss runs it again with masks of its own, as the JAX step does."""
        self._step_counter += 1
        gen_params, disc_params = self.gen_params, self.disc_params
        shard = self._spatial_shard()
        if shard is not None and self.train_remat:
            raise ValueError('train_remat on a space axis: the recomputed '
                             'forward would repeat its halo exchanges')
        gen_apply = self._maybe_remat(self._train_gen_net().apply)
        cast = self._train_cast()
        names = self.hr_exo_features
        slc = slice(0, -len(names)) if names else slice(None)
        generator = self._loss_generator()
        disc = self._disc
        space = {} if shard is None else {'spatial': shard}
        gather, gather_d = self._gather_hr, self._gather_disc()
        device = self.device
        with exact_fp32():
            with trace.device_span('train.forward', device):
                exo, state = self._train_exo(hr)
                with torch.set_grad_enabled(do_gen):
                    out = gen_apply(cast(lr), {k: cast(v) for k, v in
                                               self._layer_exo(exo).items()},
                                    **self._dropout_kwargs(self._gen, 0),
                                    **space).float()
                full = (torch.cat([out] + [exo[f] for f in names], dim=-1)
                        if names else out)
                with torch.set_grad_enabled(do_gen or do_disc):
                    with torch.set_grad_enabled(do_disc):
                        d_true = gather_d(disc.apply(
                            cast(hr), **self._dropout_kwargs(disc, 1),
                            **space).float())
                    d_gen = gather_d(disc.apply(
                        cast(full), **self._dropout_kwargs(disc, 2),
                        **space).float())
                    out_all, hr_all = gather(out), gather(hr)
                    content = apply_loss(self.loss_fun, out_all,
                                         hr_all[..., slc], generator=generator)
                    extra, details = self._extra_gen_loss(out_all, hr_all,
                                                          gather(state))
                    advers = relativistic_disc_loss(d_gen, d_true)
                    gen_loss = content + extra + weight_gen_advers * advers
                    if disc.has_dropout:
                        with torch.set_grad_enabled(do_disc):
                            kw = {**self._dropout_kwargs(disc, 3), **space}
                            disc_loss = relativistic_disc_loss(
                                gather_d(disc.apply(cast(hr), **kw).float()),
                                gather_d(disc.apply(cast(full.detach()),
                                                    **kw).float()))
                    else:
                        # the discriminator's loss reads the same outputs:
                        # its pre-update params on the generated output's
                        # value
                        disc_loss = relativistic_disc_loss(d_true, d_gen)
            if do_gen:
                with trace.device_span('train.gen_grad', device):
                    gen_grads = self._reduce_grads(torch.autograd.grad(
                        gen_loss, gen_params, retain_graph=do_disc),
                        self._gen)
            if do_disc:
                with trace.device_span('train.disc_grad', device):
                    disc_grads = self._reduce_grads(torch.autograd.grad(
                        disc_loss, disc_params), disc)
            with trace.device_span('train.update', device):
                if do_gen:
                    self._gen_tx.update(gen_params, gen_grads,
                                        self._gen_opt_state)
                if do_disc:
                    self._disc_tx.update(disc_params, disc_grads,
                                         self._disc_opt_state)
        return {'loss_gen': gen_loss, 'loss_gen_content': content + extra,
                'loss_gen_advers': advers, 'loss_disc': disc_loss,
                **details}

    def run_gradient_descent(self, low_res, hi_res_true,
                             weight_gen_advers=0.001, train_gen=True,
                             train_disc=False):
        """One gated optimization step on a (lr, hr) batch pair;
        ``train_gen`` / ``train_disc`` gate which updates apply. Returns
        the loss scalars. With a mesh attached the pair is this rank's
        block (``_place_batch``) and the losses are the global batch's."""
        return self._step_and_fetch(
            self._place_batch(low_res), self._place_batch(hi_res_true),
            weight_gen_advers, train_gen, train_disc)

    def _step_and_fetch(self, lr, hr, weight_gen_advers, train_gen,
                        train_disc):
        """``_train_step`` on device tensors, then its losses on the host
        (the spans ``train.step`` and, the host waiting for the step's
        end, ``train.fetch``)."""
        with trace.span('train.step', step=self._step_counter + 1):
            details = self._train_step(lr, hr, float(weight_gen_advers),
                                       bool(train_gen), bool(train_disc))
            with trace.span('train.fetch'):
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
        return self._step_and_fetch(lr, hr, weight_gen_advers, train_gen,
                                    train_disc)

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
        """Train data-parallel over a mesh of ranks (``parallel.get_mesh``
        or ``get_mesh_2d``, on this model's device): params and optimizer
        state are broadcast from the mesh's first rank, each rank then
        passes its OWN rows of every batch (its own batch handler, or its
        block of a global batch: ``parallel.shard_batch``) and every rank
        reports the global batch's losses and applies the same update
        (the module docstring says how). Only the first rank writes
        checkpoints, history and tensorboard files.

        ``spatial_axis`` (found on a 2D mesh when None, as the JAX
        package finds it; ``False`` keeps a 2D mesh data-only) also
        splits each sample's s1 rows over that axis: a rank passes its
        block of every batch (``parallel.shard_batch_spatial``), and in
        ``train`` the ranks of one ``space`` group feed the same samples
        (their batch handlers seeded alike), each taking its block."""
        if axis not in mesh.axis_names:
            raise ValueError(f'attach_mesh: the mesh has axes '
                             f'{mesh.axis_names}, not {axis!r}')
        if spatial_axis is None and len(mesh.axis_names) == 2:
            spatial_axis = next(a for a in mesh.axis_names if a != axis)
        spatial_axis = spatial_axis or None
        if spatial_axis is not None:
            if spatial_axis not in mesh.axis_names or spatial_axis == axis:
                raise ValueError(
                    f'attach_mesh: spatial_axis={spatial_axis!r} is not a '
                    f'second axis of the mesh {mesh.axis_names}')
            if self._spatial_refusal:
                raise ValueError(f'attach_mesh: {type(self).__name__} '
                                 f'cannot train on a space axis: '
                                 f'{self._spatial_refusal}')
        here = torch.empty(0, device=self.device).device
        if torch.empty(0, device=mesh.device).device != here:
            raise ValueError(f'attach_mesh: the mesh is on {mesh.device}, '
                             f'the model on {here}')
        self._mesh, self._mesh_axis = mesh, axis
        self._mesh_spatial_axis = spatial_axis
        if self.gen_params is not None:
            self._replicate()

    def _space_block(self, *arrays):
        """This rank's block of s1 rows (dim 1) of each of a batch's
        arrays, on the attached mesh's ``space`` axis (the arrays
        themselves without one). The first batch a ``train`` call takes
        is checked to be the same on every rank of the ``space`` group:
        each rank takes its block of the same samples."""
        axis = self._mesh_spatial_axis
        if axis is None:
            return arrays
        if self._check_space_feed:
            self._check_space_feed = False
            sums = [float(torch.as_tensor(a, dtype=torch.float64).sum())
                    for a in arrays]
            if any(got != sums for got in all_gather_object(
                    self._mesh, sums, axis)):
                raise ValueError(
                    'train on a space axis: the ranks of a space group fed '
                    'different samples; seed their batch handlers alike '
                    '(by their index on the batch axis)')
        return tuple(shard_spatial(self._mesh, a, axis, dim=1)
                     for a in arrays)

    #: whether ``_space_block`` checks the next batch (``train`` sets it)
    _check_space_feed = False

    def _replicate(self):
        """Broadcast both networks' params and optimizer states from the
        mesh's first rank."""
        replicate(self._mesh, [self.gen_params, self.disc_params,
                               self._gen_opt_state, self._disc_opt_state])
        self._gen.mark_weights_written()
        self._disc.mark_weights_written()

    # ------------------------------------------------------------------
    # inference
    #: rewrite FlexiblePadding(3)/Conv/Cropping(2) blocks into
    #: reflect-pad-1 + valid-conv for generate() — the configs compute a
    #: halo ring that is immediately cropped
    inference_fuse = True
    #: route every fused block the small kernel does not take to the
    #: hand-written ``reflect_conv`` CUDA kernel, whatever its shape
    #: (float32 only, so it refuses a bf16 body on the card, as the JAX
    #: package's Pallas kernel does). Off, each fp32 block served on the
    #: card takes the kernel where it was timed faster than cuDNN
    #: (``ops/kernels.py::body_kernel_wins``), and cuDNN elsewhere
    inference_pallas = False
    #: fold the final SpatioTemporalExpansion + tail conv to the
    #: pre-expansion resolution (``ops/subpixel.py``): one conv at
    #: m^2 * C input channels instead of a few-channel conv at HR
    inference_subpixel_tail = False
    #: reduced-precision serving: 'bfloat16' casts the input, the exo
    #: rasters and (in each layer) the params at the network boundary and
    #: the output back to float32; None serves float32
    inference_dtype = None
    #: the JAX package's shard-aligned s1 formulation for spatially
    #: sharded serving. Off (the default, and what the strategy resets it
    #: to), ``generate(..., mesh=)`` gathers the input of each block the
    #: ``small_reflect_conv`` kernel takes over the mesh's axis and runs
    #: the kernel on the whole tensor (the JAX route below its gate); on
    #: (the ForwardPass sets it on spatial meshes 4 or more wide,
    #: ``ops.conv_ad.shard_aligned_worthwhile``) every sharded block
    #: exchanges halo rows on cuDNN, and the unsharded blocks' plain route
    #: is ``ops/conv_ad.py::reflect_conv_shard_aligned``
    inference_shard_aligned = False

    @property
    def inference_mode(self):
        """Named inference profile.

        - ``'exact'`` (default): float32 body with TF32 off, the HR tail
          on the exact-fp32 ``small_reflect_conv`` kernel.
        - ``'fast'``: the subpixel tail and a bf16 body (cuDNN's bf16
          convs), the output cast back to float32; within 0.04 of the
          exact output's largest magnitude (docs/PERFORMANCE.md "Fast
          inference mode").
        - ``'custom'`` (read-only): reported when
          ``inference_subpixel_tail`` / ``inference_dtype`` were set to
          another combination by hand.
        """
        if (self.inference_subpixel_tail
                and self.inference_dtype == 'bfloat16'):
            return 'fast'
        if not self.inference_subpixel_tail and self.inference_dtype is None:
            return 'exact'
        return 'custom'

    @inference_mode.setter
    def inference_mode(self, mode):
        if mode == 'exact':
            self.inference_subpixel_tail = False
            self.inference_dtype = None
        elif mode == 'fast':
            self.inference_subpixel_tail = True
            self.inference_dtype = 'bfloat16'
        else:
            raise ValueError(
                f'inference_mode must be "exact" or "fast", got {mode!r}')

    def _get_fused_apply(self):
        """The fused generator Network for serving; rebuilt when the
        generator's parameter tensors change identity or the flags
        change. The dtype is in the key as the JAX package's is, though
        it does not change the layers."""
        params = self.gen_params
        flags = (self.inference_pallas, self.inference_dtype,
                 self.inference_subpixel_tail, self.inference_shard_aligned)
        # entries hold STRONG references to the params and compare
        # identity — an id() key could collide after the old tensors are
        # freed; entries for params that are no longer live are dropped
        entries = self._fused_cache_entries
        entries[:] = [e for e in entries if len(e[0]) == len(params)
                      and all(a is b for a, b in zip(e[0], params))]
        cached = next((e for e in entries if e[1] == flags), None)
        if cached is None:
            layers = fuse_network(list(self._gen.layers))
            if self.inference_subpixel_tail:
                layers = fuse_subpixel_tail(layers)
            for lyr in layers:
                if isinstance(lyr, FusedReflectConv):
                    lyr.use_pallas = self.inference_pallas
                    lyr.shard_aligned = self.inference_shard_aligned
            cached = (params, flags, Network(layers))
            entries.append(cached)
        return cached[2]

    @staticmethod
    def _has_output_exo(exogenous_data):
        """Whether output-combine exo steps exist (their concat is a host
        op, so they force a fetch)."""
        return any(step.get('combine_type') == 'output'
                   for val in (exogenous_data or {}).values()
                   if isinstance(val, dict)
                   for step in val.get('steps', []))

    def _norm_layer_exo(self, exo):
        """Normalize mid-network exo rasters with their own feature
        stats (training concatenates NORMALIZED exo channels, so
        inference must feed the layers the same scale); an observation
        raster (``*_obs``) takes its base feature's stats."""
        if self._means is None:
            return exo
        out = {}
        for k, v in exo.items():
            key = k if k in self._means else strip_obs_suffix(k)
            if key in self._means:
                v = (v - self._means[key]) / (self._stdevs[key] or 1.0)
            out[k] = v
        return out

    @trace.span('model.generate')
    def generate(self, low_res, norm_in=True, un_norm_out=True,
                 exogenous_data=None, fetch=True, mesh=None):
        """Public inference: (input-exo concat) -> normalize -> generator
        (+layer exo) -> denormalize on ``self.device`` -> (output-exo
        concat after the fetch), in the mode ``inference_mode``
        names (the network in ``inference_dtype``; its output, and so
        what this returns, float32 either way).

        low_res: 4D/5D channels-last physical-units array (n_obs
        first), numpy or tensor. Returns a channels-last numpy array;
        with ``fetch=False`` the output tensor on ``self.device``
        instead, without waiting for the device (the forward pass
        crops and drains it while the next batch is dispatched), unless
        output-combine exo needs the host concat. That tensor was made
        under ``torch.inference_mode``: slice it, do not modify it in
        place, and keep it out of training.

        With a 1D ``mesh`` (``parallel.get_mesh``), ``low_res`` is this
        rank's block of s1 rows of the input (``parallel.shard_spatial``)
        and the output is its block of the HR rows: every rank of the
        mesh calls this together, and each conv exchanges boundary rows
        with the neighbouring ranks, except the blocks the small kernel
        takes while ``inference_shard_aligned`` is off: those gather
        their input over the axis and keep this rank's rows of the
        kernel's output. Layer exo rasters stay full-size (each layer
        takes its rows)."""
        low_res = torch.as_tensor(low_res, dtype=torch.float32,
                                  device=self.device)
        low_res = self._combine_fwp_input(low_res, exogenous_data)
        exo = self._parse_exo_for_generate(exogenous_data)
        if norm_in and self._means is not None:
            low_res = self.norm_input(low_res)
            exo = self._norm_layer_exo(exo)
        if self.gen_params is None:
            self.init_weights(tuple(low_res.shape),
                              self._dummy_hr_shape(tuple(low_res.shape)))
        for f in self._gen.exo_features + self._gen.obs_features:
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
        dtype = compute_dtype(self.inference_dtype) or torch.float32
        # below the shard-aligned gate the small kernel's blocks gather
        # their input over the axis, as XLA gathers a pallas_call's
        # operands; with the flag set every block exchanges halo rows, as
        # the JAX package's shard-aligned route bypasses Pallas
        spatial = None if mesh is None else SpatialShard(
            mesh, gather_small=not self.inference_shard_aligned)
        with torch.inference_mode(), exact_fp32(), trace.device_span(
                'model.generate', self.device):
            out = net.apply(low_res.to(dtype), {
                k: v.to(dtype) for k, v in fixed_exo.items()},
                spatial=spatial).float()
            if un_norm is not None:
                out = out * un_norm[0] + un_norm[1]
        if not fetch and not self._has_output_exo(exogenous_data):
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

    def _saved_networks(self):
        return {'gen': self._gen, 'disc': self._disc}

    def _opt_state_tree(self):
        return {'0': opt_state_to_jax(self._gen_tx, self._gen_opt_state,
                                      self._gen),
                '1': opt_state_to_jax(self._disc_tx, self._disc_opt_state,
                                      self._disc)}

    def _set_opt_state_tree(self, tree):
        self._gen_opt_state = opt_state_from_jax(self._gen_tx, tree['0'],
                                                 self._gen)
        self._disc_opt_state = opt_state_from_jax(self._disc_tx, tree['1'],
                                                  self._disc)

    def _init_saved_shapes(self, params):
        self.init_weights(tuple(params['gen_in_shape']),
                          tuple(params['disc_in_shape']))

    @classmethod
    def _extra_load_kwargs(cls, params):
        """Constructor kwargs a subclass restores from the saved
        ``model_params`` (e.g. the observation settings)."""
        return {}

    @classmethod
    def load(cls, model_dir, verbose=True, device='cuda'):
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
            device=device, **cls._extra_load_kwargs(params))
        return model._load_saved(model_dir, params)

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

    def _train_batch(self, batch, train_gen, only_gen, gen_too_good,
                     train_disc, only_disc, disc_too_good,
                     weight_gen_advers):
        """Gated updates for one batch."""
        do_gen = bool(only_gen or (train_gen and not gen_too_good))
        do_disc = bool(only_disc or (train_disc and not disc_too_good))
        if hasattr(batch, 'sample'):
            details = self.run_gradient_descent_on_sample(
                *self._space_block(batch.sample),
                weight_gen_advers=weight_gen_advers,
                train_gen=do_gen, train_disc=do_disc)
        else:
            details = self.run_gradient_descent(
                *self._space_block(batch.low_res, batch.high_res),
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

    def _val_exo(self, hr):
        """``_train_exo`` for a validation batch."""
        return self._split_exo(hr), None

    def _val_step(self, lr, hr, weight_gen_advers):
        """The losses of one validation batch (no gradients), with the
        train step's extra loss terms; over the global batch, gathered as
        in the train step, when a mesh is attached."""
        gather = self._gather_hr
        names = self.hr_exo_features
        slc = slice(0, -len(names)) if names else slice(None)
        shard = self._spatial_shard()
        space = {} if shard is None else {'spatial': shard}
        gather_d = self._gather_disc()
        exo, state = self._val_exo(hr)
        out = self._train_gen_net().apply(lr, self._layer_exo(exo), **space)
        full = self._combine_loss_input(hr, out)
        d_true = gather_d(self._disc.apply(hr, **space))
        d_gen = gather_d(self._disc.apply(full, **space))
        full, hr = gather(full), gather(hr)
        out = full[..., :out.shape[-1]]
        content = apply_loss(self.loss_fun, full[..., slc], hr[..., slc])
        extra, details = self._extra_gen_loss(out, hr, gather(state))
        advers = relativistic_disc_loss(d_gen, d_true)
        return {'loss_disc': relativistic_disc_loss(d_true, d_gen),
                'loss_gen': content + extra + weight_gen_advers * advers,
                'loss_gen_content': content + extra,
                'loss_gen_advers': advers, **details}

    def calc_loss(self, hi_res_true, hi_res_gen, weight_gen_advers=0.001,
                  train_gen=True, train_disc=False, compute_disc=False):
        """GAN losses of a (true, generated) HR pair (reference:
        sup3r/models/base.py:830-911); returns (loss, details) as tensors
        on the model's device, without gradients."""
        hr = self._place_batch(hi_res_true)
        with torch.no_grad(), exact_fp32():
            out = self._combine_loss_input(hr, self._place_batch(
                hi_res_gen))
            if out.shape != hr.shape:
                raise RuntimeError(
                    f'Generated shape {tuple(out.shape)} != true shape '
                    f'{tuple(hr.shape)}; check enhancement factors')
            d_true = self._disc.apply(hr)
            d_gen = self._disc.apply(out)
            details, loss = {}, None
            if compute_disc or train_disc:
                details['loss_disc'] = relativistic_disc_loss(d_true, d_gen)
            if train_gen:
                names = self.hr_exo_features
                slc = slice(0, -len(names)) if names else slice(None)
                content = apply_loss(self.loss_fun, out[..., slc],
                                     hr[..., slc])
                advers = relativistic_disc_loss(d_gen, d_true)
                loss = content + weight_gen_advers * advers
                details.update(loss_gen=loss, loss_gen_content=content,
                               loss_gen_advers=advers)
            elif train_disc:
                loss = details['loss_disc']
        return loss, details

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
                    lr, hr = self._split_sample(self._place_batch(
                        *self._space_block(batch.sample)))
                else:
                    lr, hr = (self._place_batch(a) for a in self._space_block(
                        batch.low_res, batch.high_res))
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

        ``tensorboard_log=True`` writes each epoch's history row as
        scalars to ``<out_dir>/../logs`` (a warning and no logs without
        the ``tensorboard`` package); ``tensorboard_profile=True``
        records the first epoch with ``torch.profiler`` into
        ``<dirname(out_dir)>/profile`` and logs the table of the
        program's spans and counters of that epoch (``utilities.trace``:
        each span's count, total and self ms, e.g. ``train.step``,
        ``batches.wait`` and the step's device phases). ``multi_gpu`` is accepted for API
        parity, as in the JAX package: data parallelism is a mesh
        (``attach_mesh``), one process per device. The batch handler
        stages its
        batches on this model's device (its ``device``, set here when it
        has none)."""
        self._prepare_training(batch_handler, input_resolution)
        self._check_space_feed = self._mesh_spatial_axis is not None
        transform_config = getattr(batch_handler, 'transform_config',
                                   None)
        if transform_config is not None:
            self._sample_transform = transform_config
        self.init_weights((1, *batch_handler.lr_shape),
                          (1, *batch_handler.hr_shape))

        def run_epoch(epoch, profile):
            nonlocal weight_gen_advers
            with profile:
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
                'learning_rate_gen': self._optimizer_config['learning_rate'],
                'learning_rate_disc':
                    self._optimizer_disc_config['learning_rate'],
                'train_gen': int(train_gen),
                'train_disc': int(train_disc),
            }
            weight_gen_advers = self.update_adversarial_weights(
                loss_details, adaptive_update_fraction,
                adaptive_update_bounds, weight_gen_advers, train_disc)
            return {**loss_details, **extras}

        self._train_epochs(
            batch_handler, n_epoch, run_epoch, out_dir,
            checkpoint_int=checkpoint_int, early_stop_on=early_stop_on,
            early_stop_threshold=early_stop_threshold,
            early_stop_n_epoch=early_stop_n_epoch,
            tensorboard_log=tensorboard_log,
            tensorboard_profile=tensorboard_profile)
