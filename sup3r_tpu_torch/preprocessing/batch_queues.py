"""Asynchronous batch queues: host producer threads feeding the train
loop (the port of ``AbstractBatchQueue`` and ``SingleBatchQueue`` of
``sup3r_tpu/preprocessing/batch_queues.py``).

A ``queue.Queue`` of numpy batches is filled by a producer thread (with
a pool of ``max_workers`` productions in flight); the HR->LR coarsening
runs there on numpy, or with ``device_transform=True`` the queue yields
the raw HR samples (``RawBatch``) and the train step coarsens them on
the device. The dual, conditional and data-centric queues come with
their handlers (ROADMAP queue 1 item 6).
"""

import logging
import threading
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Full, Queue

import numpy as np

from sup3r_tpu_torch.ops.coarsen import (
    smooth_data,
    spatial_coarsening,
    temporal_coarsening,
)
from sup3r_tpu_torch.preprocessing.samplers import _safe_probs
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, not_ported

logger = logging.getLogger(__name__)

Batch = namedtuple('Batch', ['low_res', 'high_res'])
#: raw HR sample batch for device-side transforms (one host-to-device
#: copy; the train step derives the LR input on the device)
RawBatch = namedtuple('RawBatch', ['sample'])


class AbstractBatchQueue:
    """Prefetching batch queue over one or more samplers."""

    BATCH_CLASS = Batch

    def __init__(self, samplers, batch_size=16, n_batches=64,
                 s_enhance=1, t_enhance=1, queue_cap=4, max_workers=1,
                 transform_kwargs=None, mode='eager', thread_name='training'):
        """``mode='lazy'`` (window reads streamed from disk) comes with
        the ``chunked_io`` item."""
        if mode != 'eager':
            raise NotImplementedError(
                f"mode={mode!r}: lazy containers come with chunked_io "
                '(ROADMAP queue 1 item 5)')
        self.samplers = samplers
        self.batch_size = batch_size
        self.n_batches = n_batches
        self.s_enhance = s_enhance
        self.t_enhance = t_enhance
        self.queue = Queue(maxsize=queue_cap)
        self.max_workers = max_workers
        self.transform_kwargs = transform_kwargs or {}
        self._training_flag = threading.Event()
        self._thread = None
        self._pool = None
        self._thread_name = thread_name
        #: consumer-side wait accounting: how often the train loop found
        #: the queue empty (prefetch failing to hide producer latency)
        self._gets = 0
        self._starved_waits = 0

    # ------------------------------------------------------------------
    @property
    def container_weights(self):
        """Sampling probability per sampler, proportional to data size."""
        sizes = [s.data.size for s in self.samplers]
        total = sum(sizes)
        return np.array([s / total for s in sizes])

    def get_random_container(self):
        """Pick a sampler weighted by its data size."""
        if len(self.samplers) == 1:
            return self.samplers[0]
        idx = RANDOM_GENERATOR.choice(
            len(self.samplers), p=_safe_probs(self.container_weights))
        return self.samplers[idx]

    def sample_batch(self):
        """Draw batch_size HR samples from a random sampler and stack."""
        sampler = self.get_random_container()
        samples = [next(sampler) for _ in range(self.batch_size)]
        return np.stack(samples, axis=0)

    def transform(self, samples):
        """Produce the final (low_res, high_res) pair. Abstract."""
        raise NotImplementedError

    def post_proc(self, samples):
        """samples -> Batch namedtuple."""
        lr, hr = self.transform(samples, **self.transform_kwargs)
        return self.BATCH_CLASS(low_res=lr, high_res=hr)

    # ------------------------------------------------------------------
    # threading
    def start(self):
        """Start the producer thread."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._training_flag.set()
        self._pool = ThreadPoolExecutor(max_workers=self.max_workers)
        self._thread = threading.Thread(
            target=self._enqueue_batches,
            name=f'{self._thread_name}_queue', daemon=True)
        self._thread.start()

    def stop(self):
        """Stop the producer and drain the queue."""
        self._training_flag.clear()
        while True:
            try:
                self.queue.get_nowait()
            except Empty:
                break
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def _enqueue_batches(self):
        """Producer loop: keeps ``max_workers`` batch productions in
        flight on the pool."""
        def produce():
            return self.post_proc(self.sample_batch())

        pending = []
        try:
            while self._training_flag.is_set():
                while (len(pending) < max(self.max_workers, 1)
                       and self._training_flag.is_set()):
                    pending.append(self._pool.submit(produce))
                fut = pending.pop(0)
                try:
                    batch = fut.result()
                except Exception:
                    logger.exception('Batch producer error')
                    raise
                while self._training_flag.is_set():
                    try:
                        self.queue.put(batch, timeout=0.2)
                        break
                    except Full:
                        continue
        finally:
            for fut in pending:
                fut.cancel()

    def __len__(self):
        return self.n_batches

    @property
    def starvation_rate(self):
        """Fraction of batch fetches that found the queue empty (0.0 =
        prefetch fully hides production latency)."""
        if self._gets == 0:
            return 0.0
        return self._starved_waits / self._gets

    def _get(self):
        """The next batch; None once stopped. Raises when the producer
        died."""
        starved = False
        while True:
            try:
                batch = self.queue.get(timeout=1.0)
                self._gets += 1
                self._starved_waits += int(starved)
                return batch
            except Empty:
                starved = True
                if not self._training_flag.is_set():
                    return None
                if self._thread is None or not self._thread.is_alive():
                    raise RuntimeError(
                        'Batch producer thread died (see "Batch '
                        'producer error" traceback in the log)')

    def __iter__(self):
        self.start()
        for _ in range(self.n_batches):
            batch = self._get()
            if batch is None:
                return
            yield batch

    def __next__(self):
        self.start()
        batch = self._get()
        if batch is None:
            raise StopIteration
        return batch


class SingleBatchQueue(AbstractBatchQueue):
    """Queue producing (lr, hr) by coarsening sampled HR data.

    With ``device_transform=True`` the queue yields raw HR samples
    (RawBatch) and the train step coarsens them on the device: one
    host-to-device copy instead of two, and no host CPU spent on the
    transform."""

    def __init__(self, samplers, device_transform=False, **kwargs):
        self.device_transform = device_transform
        super().__init__(samplers, **kwargs)
        s = self.samplers[0]
        self.features = s.features
        self.lr_features = s.lr_features
        self.hr_exo_features = s.hr_exo_features
        self.hr_out_features = s.hr_out_features
        self.hr_features_ind = s.hr_features_ind
        self.sample_shape = s.sample_shape
        self._is_4d = self.sample_shape[2] == 1 and self.t_enhance == 1
        # fail at construction, not in the producer thread
        bad = [tuple(x.sample_shape) for x in self.samplers
               if tuple(x.sample_shape) != tuple(self.sample_shape)]
        assert not bad, (
            'All samplers in a queue must share one sample_shape; got '
            f'{tuple(self.sample_shape)} and {bad}')
        bad_feats = [list(x.features) for x in self.samplers
                     if list(x.features) != list(self.features)]
        assert not bad_feats, (
            'All samplers in a queue must share one feature list; got '
            f'{list(self.features)} and {bad_feats}')
        assert self.sample_shape[0] % self.s_enhance == 0 and (
            self.sample_shape[1] % self.s_enhance == 0), (
            f's_enhance={self.s_enhance} must evenly divide the '
            f'spatial sample shape {self.sample_shape[:2]}')
        assert self._is_4d or (
            self.t_enhance <= self.sample_shape[2]
            and self.sample_shape[2] % self.t_enhance == 0), (
            f't_enhance={self.t_enhance} must evenly divide the '
            f'temporal sample shape {self.sample_shape[2]}')

    @property
    def lr_shape(self):
        """(s1, s2[, t], f) of one LR observation."""
        s1 = self.sample_shape[0] // self.s_enhance
        s2 = self.sample_shape[1] // self.s_enhance
        t = self.sample_shape[2] // self.t_enhance
        nf = len(self.lr_features)
        return (s1, s2, nf) if self._is_4d else (s1, s2, t, nf)

    @property
    def hr_shape(self):
        """(s1, s2[, t], f) of one HR observation."""
        s1, s2, t = self.sample_shape
        nf = len(self.hr_features_ind)
        return (s1, s2, nf) if self._is_4d else (s1, s2, t, nf)

    def transform(self, samples, smoothing=None, smoothing_ignore=None,
                  temporal_coarsening_method='subsample'):
        """HR batch (n, s1, s2, t, f) -> (lr, hr) pair."""
        lr = spatial_coarsening(samples, self.s_enhance)
        if self.t_enhance > 1:
            lr = temporal_coarsening(lr, self.t_enhance,
                                     temporal_coarsening_method)
        if smoothing is not None:
            lr = smooth_data(np.array(lr), self.features,
                             smoothing_ignore or [], smoothing)
        hr = samples[..., self.hr_features_ind]
        if self._is_4d:
            lr = lr[:, :, :, 0, :]
            hr = hr[:, :, :, 0, :]
        return np.ascontiguousarray(lr), np.ascontiguousarray(hr)

    @property
    def transform_config(self):
        """Static description of the HR->LR transform for device-side
        execution by the train step."""
        return {
            's_enhance': self.s_enhance,
            't_enhance': self.t_enhance,
            'method': self.transform_kwargs.get(
                'temporal_coarsening_method', 'subsample'),
            'hr_features_ind': tuple(self.hr_features_ind),
            'squeeze_time': self._is_4d,
        }

    def post_proc(self, samples):
        if self.device_transform:
            if self.transform_kwargs.get('smoothing'):
                raise NotImplementedError(
                    'smoothing is a host-side transform; use '
                    'device_transform=False with smoothing')
            return RawBatch(sample=np.ascontiguousarray(samples))
        return super().post_proc(samples)


__getattr__ = not_ported(
    __name__, ('DualBatchQueue', 'ConditionalBatchQueue', 'QueueMom1',
               'QueueMom1SF', 'QueueMom2', 'QueueMom2Sep', 'QueueMom2SF',
               'QueueMom2SepSF', 'BatchQueueDC', 'ValBatchQueueDC'),
    'ROADMAP queue 1 item 6, the dual, conditional and data-centric '
    'queues')
