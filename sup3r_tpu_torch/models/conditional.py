"""Sup3rCondMom: conditional-moment (non-adversarial) estimator (the port
of ``sup3r_tpu/models/conditional.py``).

One generator learns a conditional moment of the HR field given the LR
field (E[HR|LR], E[(HR - E[HR|LR])^2|LR], or their subfilter forms) with
a masked pointwise loss; the ``QueueMom*`` batch queues build the target
(``output``) and the padding ``mask`` of each batch.

The train step runs the generator fused (``train_fuse``), so its HR tail
launches ``small_reflect_conv`` on the card under autograd as
``Sup3rGan``'s does, in ``train_dtype`` / with ``train_remat`` where set;
the loss is taken on ``output * mask`` against ``out * mask``, with the
TARGET's exo channels appended to ``out`` (a second-moment target
transforms them, so appending the HR batch's would add a loss term); the
optimizer is the port's optax-exact one; the whole step, backward
included, runs with TF32 off. ``generate`` serves through the same fused
network. Saves use the JAX package's layout, so a checkpoint resumes in
either package.

Reference parity: sup3r/models/conditional.py:30-489.
"""

import contextlib
import logging

import numpy as np
import torch

from sup3r_tpu_torch.models.abstract import AbstractSingleModel
from sup3r_tpu_torch.models.optimizers import make_optimizer
from sup3r_tpu_torch.ops.losses import apply_loss
from sup3r_tpu_torch.utilities import exact_fp32, resolve_device

logger = logging.getLogger(__name__)


class Sup3rCondMom(AbstractSingleModel):
    """Conditional moment estimator (single network, masked loss)."""

    def __init__(self, gen_layers, optimizer=None, learning_rate=1e-4,
                 loss='MeanSquaredError', meta=None, means=None,
                 stdevs=None, name=None, device='cuda'):
        """
        Parameters
        ----------
        gen_layers : list | dict | str
            ``hidden_layers`` config list (or a dict holding one), or path
            to a JSON file with a ``hidden_layers`` key.
        optimizer : dict | None
            Optimizer config like ``{'name': 'Adam', 'learning_rate':
            1e-4}`` (``models/optimizers.py``); ``learning_rate`` is the
            shortcut, as in the JAX package.
        device : str | torch.device
            Where the generator lives, trains and serves. A CUDA device
            with no card raises; pass ``'cpu'`` for the CPU.
        """
        super().__init__()
        self.device = resolve_device(device)
        self.name = name or type(self).__name__
        self._gen = self.load_network(gen_layers, 'generator')
        self._gen_config = self._gen.config
        if optimizer is None:
            optimizer = {'name': 'Adam', 'learning_rate': learning_rate}
        self._gen_tx, self._optimizer_config = make_optimizer(optimizer)
        self.set_loss_function(loss)
        self.meta = meta if meta is not None else {}
        self.set_norm_stats(means, stdevs)
        self._gen_opt_state = None
        self._gen_in_shape = None
        self._init_seed = 42
        #: the stream of ``batch_output``'s copies and launches
        self._side_stream = None

    def init_weights(self, lr_shape, hr_shape=None, seed=None):
        """Initialize the generator's params and optimizer state for a
        channels-last input shape, from a ``torch.Generator`` seeded
        with ``seed`` (42 by default). As in the JAX package, a model
        that has weights keeps them. The draws differ from the JAX
        package's; carry JAX weights across with ``params_from_jax`` /
        ``load``."""
        if seed is not None:
            self._init_seed = seed
        if self.gen_params is not None:
            return
        self._gen.init(lr_shape, torch.Generator().manual_seed(
            self._init_seed))
        self._gen.to(self.device)
        self._gen.mark_weights_written()
        self._gen_in_shape = tuple(lr_shape)
        for p in self._gen.parameters():
            p.requires_grad_(True)
        self._gen_opt_state = self._gen_tx.init(self.gen_params)

    def update_optimizer(self, **kwargs):
        """Update the optimizer's config (e.g. learning_rate) mid-training;
        its state (Adam's moments and count) is kept."""
        self._gen_tx, self._optimizer_config = make_optimizer(
            {**self._optimizer_config, **kwargs})

    def calc_loss(self, output_true, output_gen, mask):
        """Masked pointwise loss of a generated output (the target's exo
        channels appended) against the moment target; (loss, details)
        as tensors on the model's device."""
        output_true = self._place_batch(output_true)
        output_gen = self._combine_loss_input(
            output_true, self._place_batch(output_gen))
        if output_gen.shape != output_true.shape:
            raise RuntimeError(
                f'Generated shape {tuple(output_gen.shape)} != target '
                f'{tuple(output_true.shape)}')
        mask = self._place_batch(mask)
        loss = apply_loss(self.loss_fun, output_gen * mask,
                          output_true * mask)
        return loss, {'loss_gen': loss}

    # ------------------------------------------------------------------
    # the train step
    def _train_step(self, lr, hr, output, mask):
        """One step on device tensors; returns the loss (a device
        tensor)."""
        params = self.gen_params
        gen_apply = self._maybe_remat(self._train_gen_net().apply)
        cast = self._train_cast()
        with exact_fp32():
            exo = {k: cast(v) for k, v in self._split_exo(hr).items()}
            out = gen_apply(cast(lr), exo).float()
            if self.hr_exo_features:
                out = torch.cat([out, output[..., out.shape[-1]:]], dim=-1)
            loss = apply_loss(self.loss_fun, out * mask, output * mask)
            grads = torch.autograd.grad(loss, params)
            self._gen_tx.update(params, grads, self._gen_opt_state)
        self._gen.mark_weights_written()
        return {'loss_gen': loss}

    def run_gradient_descent(self, batch):
        """One optimization step on a conditional batch (``low_res``,
        ``high_res``, ``output``, ``mask``: numpy arrays or tensors);
        returns the loss scalars."""
        details = self._train_step(*(
            self._place_batch(getattr(batch, k))
            for k in ('low_res', 'high_res', 'output', 'mask')))
        return self._fetch_details(details)

    # ------------------------------------------------------------------
    # inference
    def generate(self, low_res, norm_in=True, un_norm_out=True,
                 exogenous_data=None):
        """Moment prediction in physical units: (input-exo concat) ->
        normalize -> the fused generator (+layer exo) -> denormalize, on
        ``self.device``; returns a channels-last numpy array."""
        low_res = torch.as_tensor(low_res, dtype=torch.float32,
                                  device=self.device)
        low_res = self._combine_fwp_input(low_res, exogenous_data)
        exo = self._parse_exo_for_generate(exogenous_data)
        if norm_in and self._means is not None:
            low_res = self.norm_input(low_res)
        if self.gen_params is None:
            self.init_weights(tuple(low_res.shape))
        with torch.inference_mode(), exact_fp32():
            out = self._train_gen_net().apply(low_res, exo).float()
            if un_norm_out and self._means is not None:
                out = self.un_norm_output(out)
        return out.cpu().numpy()

    def _stream(self):
        """A context on this model's side stream (none on the CPU). The
        stream first waits for the generator's last weight writes that
        were marked (``Network.mark_weights_written``: ``init_weights``,
        ``load`` and any ``params_from_jax``, each train step), not for
        the rest of the work queued on other streams."""
        if self.device.type != 'cuda':
            return contextlib.nullcontext()
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        if self._gen.weights_event is not None:
            self._side_stream.wait_event(self._gen.weights_event)
        return torch.cuda.stream(self._side_stream)

    def batch_output(self, low_res, hi_res):
        """The generator's output on a normalized training batch (numpy
        ``low_res`` / ``hi_res``), with ``hi_res``'s exo channels
        appended, as host numpy: the first-moment prediction that the
        second-moment queues subtract. A queue's producer thread calls
        it while the train step runs, so on the card its copies and
        launches go to a stream of its own, not the step's; that stream
        waits for the generator's last weight writes (``_stream``)."""
        exo = self.get_hr_exo_input(np.asarray(hi_res))
        host = [np.ascontiguousarray(low_res, np.float32)] + [
            np.ascontiguousarray(exo[f], np.float32)
            for f in self.hr_exo_features]
        pinned = self.device.type == 'cuda'
        host = [torch.from_numpy(a) for a in host]
        with self._stream(), torch.inference_mode(), exact_fp32():
            lr, *exo_in = [(t.pin_memory() if pinned else t).to(
                self.device, non_blocking=pinned) for t in host]
            out = self._train_gen_net().apply(
                lr, dict(zip(self.hr_exo_features, exo_in))).float()
            out = out.cpu().numpy()
        if self.hr_exo_features:
            out = np.concatenate(
                [out] + [exo[f] for f in self.hr_exo_features], axis=-1)
        return out

    # ------------------------------------------------------------------
    # save / load
    @property
    def model_params(self):
        params = super().model_params
        params.update({
            'gen_config': self._gen_config,
            'gen_in_shape': self._gen_in_shape,
            'optimizer': self._optimizer_config,
        })
        return params

    @classmethod
    def load(cls, model_dir, device='cuda', verbose=True):
        """Load a conditional model that ``save`` here or the JAX
        package's ``Sup3rCondMom.save`` wrote: ``model_params.json``,
        ``model_gen.msgpack``, and ``opt_state.msgpack`` /
        ``history.csv`` where present."""
        params = cls.load_saved_params(model_dir, verbose=verbose)
        model = cls(params['gen_config'], optimizer=params.get('optimizer'),
                    loss=params.get('loss', 'MeanSquaredError'),
                    meta=params.get('meta', {}), means=params.get('means'),
                    stdevs=params.get('stdevs'), device=device)
        return model._load_saved(model_dir, params)

    # ------------------------------------------------------------------
    # training loop
    def calc_val_loss(self, batch_handler):
        """Mean validation loss over the val queue's batches."""
        val = getattr(batch_handler, 'val_data', None)
        if val is None or (hasattr(val, '__len__') and len(val) == 0):
            return {}
        losses = []
        net = self._train_gen_net()
        with torch.no_grad(), exact_fp32():
            for batch in val:
                out = net.apply(self._place_batch(batch.low_res),
                                self._split_exo(self._place_batch(
                                    batch.high_res)))
                losses.append(self.calc_loss(batch.output, out,
                                             batch.mask)[0])
        loss = self._fetch_details({'loss': torch.stack(losses).mean()})
        return {'val_loss_gen': loss['loss']}

    def train(self, batch_handler, input_resolution, n_epoch,
              checkpoint_int=None, out_dir='./cond_mom_{epoch}',
              early_stop_on=None, early_stop_threshold=0.005,
              early_stop_n_epoch=5, multi_gpu=False,
              tensorboard_log=False):
        """Train the conditional moment estimator over a batch handler's
        epochs, with validation, history, early stopping, checkpoints
        and (``tensorboard_log``) tensorboard scalars in
        ``<out_dir>/../logs`` (reference: conditional.py:315-480).
        ``multi_gpu`` is accepted for API parity, as in the JAX package.
        The batch handler stages its batches on this model's device (its
        ``device``, set here when it has none)."""
        self._prepare_training(batch_handler, input_resolution)
        self.init_weights((1, *batch_handler.lr_shape))

        def run_epoch(epoch, profile):
            with profile:
                batch_losses = [
                    self.run_gradient_descent(batch)['loss_gen']
                    for batch in batch_handler]
            loss_details = {'train_loss_gen': float(np.mean(batch_losses))}
            loss_details.update(self.calc_val_loss(batch_handler))
            logger.info('Epoch %d cond-mom loss %.3e', epoch,
                        loss_details['train_loss_gen'])
            return loss_details

        self._train_epochs(
            batch_handler, n_epoch, run_epoch, out_dir,
            checkpoint_int=checkpoint_int, early_stop_on=early_stop_on,
            early_stop_threshold=early_stop_threshold,
            early_stop_n_epoch=early_stop_n_epoch,
            tensorboard_log=tensorboard_log)
