"""Batch handlers: (train queue, val queue, stats) composition (the port
of ``BaseBatchHandler`` and ``BatchHandler`` of
``sup3r_tpu/preprocessing/batch_handlers.py``).

Iterating a handler stages each batch on the model's device one batch
ahead of use, as ``jax.device_put`` did in the JAX package: the arrays
are copied into pinned host memory and sent with a ``non_blocking`` copy
on a side stream; the train step's stream waits on an event recorded
after the copy. A pageable copy would block the host behind the running
step. The dual, conditional and data-centric handlers come with their
queues (ROADMAP queue 1 item 6).
"""

import logging
from collections import namedtuple

import numpy as np
import torch

from sup3r_tpu_torch.preprocessing.batch_queues import SingleBatchQueue
from sup3r_tpu_torch.preprocessing.samplers import Sampler
from sup3r_tpu_torch.preprocessing.stats import (
    StatsCollection,
    unwrap_container,
)
from sup3r_tpu_torch.utilities import not_ported

logger = logging.getLogger(__name__)

#: a batch on its way to the device: the batch of device tensors and the
#: event recorded after its copy (the pinned host buffers are held by
#: torch's host allocator until the copy is done)
_Staged = namedtuple('_Staged', ['batch', 'event'])


class _EmptyVal:
    """Empty validation iterable."""

    def __len__(self):
        return 0

    def __iter__(self):
        return iter(())


class BaseBatchHandler:
    """Common composition: stats -> samplers -> train/val queues."""

    SAMPLER = Sampler
    MAIN_QUEUE = SingleBatchQueue
    VAL_QUEUE = SingleBatchQueue

    def __init__(self, train_containers, val_containers=None,
                 batch_size=16, n_batches=64, s_enhance=1, t_enhance=1,
                 means=None, stds=None, sample_shape=None,
                 feature_sets=None, queue_cap=4, max_workers=1,
                 transform_kwargs=None, mode='eager',
                 sampler_kwargs=None, queue_kwargs=None,
                 device_transform=False, device=None, **kwargs):
        """Extra **kwargs are forwarded to the queue. ``device`` is where
        iteration stages the batches; ``Sup3rGan.train`` sets it to the
        model's device when it is None."""
        queue_kwargs = {**(queue_kwargs or {}), **kwargs}
        val_containers = val_containers or []
        if device_transform:
            queue_kwargs['device_transform'] = True
        self.s_enhance = s_enhance
        self.t_enhance = t_enhance
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.device = None if device is None else torch.device(device)

        stats = StatsCollection(
            list(train_containers) + list(val_containers),
            means=means, stds=stds)
        self.means = stats.means
        self.stds = stats.stds

        sampler_kwargs = dict(sampler_kwargs or {})
        self._sampler_args = dict(
            sample_shape=sample_shape, batch_size=batch_size,
            feature_sets=feature_sets, **sampler_kwargs)
        samplers = [self._make_sampler(c) for c in train_containers]
        reserved = {'batch_size', 'n_batches', 's_enhance', 't_enhance',
                    'queue_cap', 'max_workers', 'transform_kwargs'}
        clash = reserved & set(queue_kwargs)
        if clash:
            raise ValueError(
                f'queue_kwargs {sorted(clash)} collide with dedicated '
                f'{type(self).__name__} arguments — pass them '
                'directly (e.g. batch_size=...) instead')
        queue_kwargs = dict(
            batch_size=batch_size, n_batches=n_batches,
            s_enhance=s_enhance, t_enhance=t_enhance,
            queue_cap=queue_cap, max_workers=max_workers,
            transform_kwargs=transform_kwargs, mode=mode, **queue_kwargs)
        self._queue = self.MAIN_QUEUE(samplers, **queue_kwargs)

        if val_containers:
            val_samplers = [self._make_sampler(c) for c in val_containers]
            vq_kwargs = dict(queue_kwargs)
            vq_kwargs['thread_name'] = 'validation'
            self.val_data = self.VAL_QUEUE(val_samplers, **vq_kwargs)
        else:
            self.val_data = _EmptyVal()

        # metadata forwarded to the model at train() time
        q = self._queue
        self.lr_features = q.lr_features
        self.hr_exo_features = q.hr_exo_features
        self.hr_out_features = q.hr_out_features
        self.smoothing = (transform_kwargs or {}).get('smoothing')
        ignore = (transform_kwargs or {}).get('smoothing_ignore', [])
        self.smoothed_features = [
            f for f in self.lr_features if f not in ignore
        ] if self.smoothing else []

    def _make_sampler(self, container):
        return self.SAMPLER(unwrap_container(container),
                            **self._sampler_args)

    @property
    def transform_config(self):
        """Device-side transform description (None unless
        device_transform=True)."""
        if getattr(self._queue, 'device_transform', False):
            return self._queue.transform_config
        return None

    @property
    def lr_shape(self):
        """Per-observation LR shape."""
        return self._queue.lr_shape

    @property
    def hr_shape(self):
        """Per-observation HR shape."""
        return self._queue.hr_shape

    @property
    def shapes(self):
        """(1, *lr_shape), (1, *hr_shape) pair."""
        return (1, *self.lr_shape), (1, *self.hr_shape)

    def __len__(self):
        return self.n_batches

    def _stage(self, batch, stream):
        """Start ``batch``'s copy to the device on ``stream``."""
        host = [torch.from_numpy(np.ascontiguousarray(m)).pin_memory()
                for m in batch]
        with torch.cuda.stream(stream):
            moved = [h.to(self.device, non_blocking=True) for h in host]
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(type(batch)(*moved), event)

    def __iter__(self):
        """Iterate batches of tensors on ``self.device``, the next
        batch's copy in flight while the current one is used (on a CUDA
        device)."""
        device = self.device or torch.device('cpu')
        if device.type != 'cuda':
            for batch in self._queue:
                yield type(batch)(*[torch.as_tensor(m, device=device)
                                    for m in batch])
            return
        stream = torch.cuda.Stream(device)
        pending = None
        for batch in self._queue:
            staged = self._stage(batch, stream)
            if pending is not None:
                yield self._ready(pending)
            pending = staged
        if pending is not None:
            yield self._ready(pending)

    def _ready(self, staged):
        """The staged batch, once the current stream has waited on its
        copy (and the allocator knows the current stream uses it)."""
        current = torch.cuda.current_stream(self.device)
        current.wait_event(staged.event)
        for t in staged.batch:
            t.record_stream(current)
        return staged.batch

    def __next__(self):
        return next(self._queue)

    def start(self):
        """Start producer threads."""
        self._queue.start()

    def stop(self):
        """Stop producer threads."""
        self._queue.stop()
        if hasattr(self.val_data, 'stop'):
            self.val_data.stop()


class BatchHandler(BaseBatchHandler):
    """Uniform sampling + coarsening transform."""


__getattr__ = not_ported(
    __name__, ('DualBatchHandler', 'BatchHandlerCC', 'BatchHandlerMom1',
               'BatchHandlerMom1SF', 'BatchHandlerMom2', 'BatchHandlerMom2Sep',
               'BatchHandlerMom2SF', 'BatchHandlerMom2SepSF',
               'BatchHandlerDC'),
    'ROADMAP queue 1 item 6, the dual, conditional and data-centric '
    'handlers')
