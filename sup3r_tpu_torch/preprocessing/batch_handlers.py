"""Batch handlers: (train queue, val queue, stats) composition (the port
of ``BaseBatchHandler`` and ``BatchHandler`` of
``sup3r_tpu/preprocessing/batch_handlers.py``).

Iterating a handler stages each batch on the model's device one batch
ahead of use, as ``jax.device_put`` did in the JAX package: every array
of the batch (a conditional batch's target and mask too) is copied into
pinned host memory and sent with a ``non_blocking`` copy on a side
stream; the train step's stream waits on an event recorded after the
copies. A pageable copy would block the host behind the running
step. ``DualBatchHandler`` feeds pre-paired LR / HR data (a
``DualRasterizer``'s); ``BatchHandlerCC`` feeds daily LR / hourly HR
pairs from the daily data handlers; ``BatchHandlerDC`` samples from
loss-adaptive bins with a per-bin validation queue; the
``BatchHandlerMom*`` handlers feed ``Sup3rCondMom`` its conditional
batches (``lower_models`` and the paddings go through ``queue_kwargs``).
"""

import logging
from collections import namedtuple

import numpy as np
import torch

from sup3r_tpu_torch.preprocessing.batch_queues import (
    BatchQueueDC,
    DualBatchQueue,
    QueueMom1,
    QueueMom1SF,
    QueueMom2,
    QueueMom2Sep,
    QueueMom2SepSF,
    QueueMom2SF,
    SingleBatchQueue,
    ValBatchQueueDC,
)
from sup3r_tpu_torch.preprocessing.samplers import (
    DualSampler,
    DualSamplerCC,
    Sampler,
    SamplerDC,
)
from sup3r_tpu_torch.preprocessing.stats import (
    StatsCollection,
    unwrap_container,
)
from sup3r_tpu_torch.utilities import trace

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

    @trace.span('batches.stage')
    def _stage(self, batch, stream):
        """Start the copy of every array of ``batch`` to the device on
        ``stream``, behind one event."""
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
        device). Each resumption up to its yield is the span
        ``batches.next``."""
        device = self.device or torch.device('cpu')
        batches = iter(self._queue)
        if device.type != 'cuda':
            while True:
                with trace.span('batches.next'):
                    batch = next(batches, None)
                    if batch is None:
                        return
                    batch = type(batch)(*[torch.as_tensor(m, device=device)
                                          for m in batch])
                yield batch
        stream = torch.cuda.Stream(device)
        pending = None
        while True:
            with trace.span('batches.next'):
                batch = next(batches, None)
                if pending is None and batch is not None:  # the first
                    pending = self._stage(batch, stream)
                    batch = next(batches, None)
                if pending is None:
                    return
                staged = None if batch is None else self._stage(batch,
                                                                stream)
                ready, pending = self._ready(pending), staged
            yield ready

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


class DualBatchHandler(BaseBatchHandler):
    """Pre-paired LR / HR containers (a ``DualRasterizer`` or a
    ``PairedDataset`` each)."""

    SAMPLER = DualSampler
    MAIN_QUEUE = DualBatchQueue
    VAL_QUEUE = DualBatchQueue

    def _make_sampler(self, container):
        return self.SAMPLER(unwrap_container(container),
                            s_enhance=self.s_enhance,
                            t_enhance=self.t_enhance,
                            **self._sampler_args)


class BatchHandlerCC(DualBatchHandler):
    """Climate-change handler: daily LR / hourly HR pairs from the daily
    data handlers' (daily, hourly) data. Its LR shape has the sample's
    days times the model's ``t_enhance`` / 24 steps: the HR sample is
    ``t_enhance`` x the LR one even where the sampler reduced a day to its
    daylight window."""

    SAMPLER = DualSamplerCC

    @property
    def hr_shape(self):
        s = self._queue.samplers[0]
        return (*s.hr_sample_shape, len(s.hr_features))

    @property
    def lr_shape(self):
        s = self._queue.samplers[0]
        t = s.hr_sample_shape[2] // s.t_enhance
        return (s.lr_sample_shape[0], s.lr_sample_shape[1], t,
                len(s.lr_features))



class BatchHandlerMom1(BaseBatchHandler):
    """Conditional first-moment batches."""

    MAIN_QUEUE = QueueMom1
    VAL_QUEUE = QueueMom1


class BatchHandlerMom1SF(BaseBatchHandler):
    """First moment of the subfilter field."""

    MAIN_QUEUE = QueueMom1SF
    VAL_QUEUE = QueueMom1SF


class BatchHandlerMom2(BaseBatchHandler):
    """Second moment (needs ``lower_models={1: mom1_model}`` in
    ``queue_kwargs``)."""

    MAIN_QUEUE = QueueMom2
    VAL_QUEUE = QueueMom2


class BatchHandlerMom2Sep(BaseBatchHandler):
    """Second moment, separate."""

    MAIN_QUEUE = QueueMom2Sep
    VAL_QUEUE = QueueMom2Sep


class BatchHandlerMom2SF(BaseBatchHandler):
    """Second moment of the subfilter field (needs ``lower_models``)."""

    MAIN_QUEUE = QueueMom2SF
    VAL_QUEUE = QueueMom2SF


class BatchHandlerMom2SepSF(BaseBatchHandler):
    """Second moment of the subfilter field, separate."""

    MAIN_QUEUE = QueueMom2SepSF
    VAL_QUEUE = QueueMom2SepSF


class BatchHandlerDC(BaseBatchHandler):
    """Data-centric handler: loss-adaptive bin sampling and a per-bin
    validation queue (reference: batch_handlers/dc.py:24). Validation
    data is required: the bin weights follow per-bin validation
    losses."""

    SAMPLER = SamplerDC
    MAIN_QUEUE = BatchQueueDC
    VAL_QUEUE = ValBatchQueueDC

    def __init__(self, train_containers, val_containers=None, *args,
                 n_space_bins=1, n_time_bins=1, **kwargs):
        if not val_containers:
            raise ValueError(
                'BatchHandlerDC requires validation data: the bin weights '
                'adapt to per-bin validation losses. Use a non-DC batch '
                'handler without validation data')
        kwargs.setdefault('queue_kwargs', {})
        kwargs['queue_kwargs'].update(n_space_bins=n_space_bins,
                                      n_time_bins=n_time_bins)
        self.n_space_bins = n_space_bins
        self.n_time_bins = n_time_bins
        super().__init__(train_containers, val_containers, *args, **kwargs)
        # every bin needs a sample start: fail here, not in the producer
        ss = tuple(self._sampler_args['sample_shape'] or (10, 10, 1))
        if len(ss) == 2:
            ss = (*ss, 1)
        for c in train_containers:
            shape = c.shape[:3]
            max_space = (shape[0] - ss[0] + 1) * (shape[1] - ss[1] + 1)
            max_time = max(shape[2] - ss[2] + 1, 1)
            if n_space_bins > max_space or n_time_bins > max_time:
                raise ValueError(
                    f'sample_shape {tuple(ss)} is too large for '
                    f'(n_space_bins={n_space_bins}, '
                    f'n_time_bins={n_time_bins}) on data of shape '
                    f'{tuple(shape)}: only {max_space} spatial and '
                    f'{max_time} temporal sample starts exist')

    @property
    def spatial_weights(self):
        return self._queue.spatial_weights

    @property
    def temporal_weights(self):
        return self._queue.temporal_weights

    def update_weights(self, spatial_weights, temporal_weights):
        """Push new bin weights (``Sup3rGanDC`` does each epoch)."""
        self._queue.update_weights(spatial_weights, temporal_weights)
