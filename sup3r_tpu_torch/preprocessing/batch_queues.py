"""Asynchronous batch queues: host producer threads feeding the train
loop (the port of ``AbstractBatchQueue`` and ``SingleBatchQueue`` of
``sup3r_tpu/preprocessing/batch_queues.py``).

A ``queue.Queue`` of numpy batches is filled by a producer thread (with
a pool of ``max_workers`` productions in flight); the HR->LR coarsening
runs there on numpy, or with ``device_transform=True`` the queue yields
the raw HR samples (``RawBatch``) and the train step coarsens them on
the device. ``DualBatchQueue`` stacks pre-paired (lr, hr) samples;
``BatchQueueDC`` / ``ValBatchQueueDC`` sample from loss-adaptive bins.
``ConditionalBatchQueue`` and its ``QueueMom*`` subclasses add a
padding mask and a moment target to each batch (``ConditionalBatch``);
the second-moment queues run the first-moment model (``lower_models``)
in the producer thread.
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
    spatial_simple_enhancing,
    temporal_coarsening,
    temporal_simple_enhancing,
)
from sup3r_tpu_torch.preprocessing.samplers import _safe_probs
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, trace

logger = logging.getLogger(__name__)

Batch = namedtuple('Batch', ['low_res', 'high_res'])
BatchWithObs = namedtuple('BatchWithObs', ['low_res', 'high_res', 'obs'])
#: raw HR sample batch for device-side transforms (one host-to-device
#: copy; the train step derives the LR input on the device)
RawBatch = namedtuple('RawBatch', ['sample'])
#: a conditional-moment batch: the moment target and the padding mask
#: beside the (lr, hr) pair, all staged to the device together
ConditionalBatch = namedtuple(
    'ConditionalBatch', ['low_res', 'high_res', 'output', 'mask'])


class AbstractBatchQueue:
    """Prefetching batch queue over one or more samplers."""

    BATCH_CLASS = Batch

    def __init__(self, samplers, batch_size=16, n_batches=64,
                 s_enhance=1, t_enhance=1, queue_cap=4, max_workers=1,
                 transform_kwargs=None, mode='eager', thread_name='training'):
        """``mode`` is a no-op at the queue level: laziness lives in the
        dataset. Build the containers with ``DataHandler(mode='lazy')``
        and the samplers' window reads stream from disk inside these
        producer threads."""
        if mode not in ('eager', 'lazy'):
            raise ValueError(f"mode must be 'eager' or 'lazy', got {mode!r}")
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
        return self._stack(samples)

    def _stack(self, samples):
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
            with trace.span('batches.produce'):
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
        """Fraction of batch fetches that waited through at least one
        whole 1 s ``queue.get`` timeout (0.0 = no fetch waited that long;
        the shorter waits are the span ``batches.wait`` and the counter
        ``batches.waited``, under a profiler)."""
        if self._gets == 0:
            return 0.0
        return self._starved_waits / self._gets

    def _get(self):
        """The next batch; None once stopped. Raises when the producer
        died."""
        with trace.span('batches.wait'):
            try:
                batch = self.queue.get_nowait()
            except Empty:
                trace.count('batches.waited')
                batch = self._wait()
            if batch is not None:
                self._gets += 1
                trace.count('batches.gets')
            return batch

    def _wait(self):
        """``_get`` once the queue was found empty."""
        starved = False
        while True:
            try:
                batch = self.queue.get(timeout=1.0)
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


class DualBatchQueue(AbstractBatchQueue):
    """Queue of pre-paired (lr, hr[, obs]) samples (reference:
    batch_queues/dual.py:14)."""

    def __init__(self, samplers, **kwargs):
        super().__init__(samplers, **kwargs)
        s = self.samplers[0]
        self.lr_features = s.lr_features
        self.hr_exo_features = s.hr_exo_features
        self.hr_out_features = s.hr_out_features
        self.features = s.features
        self.sample_shape = s.hr_sample_shape
        self._has_obs = getattr(s, 'obs_data', None) is not None
        self._is_4d = self.sample_shape[2] == 1 and self.t_enhance == 1
        self._check_enhancement_factors()

    def _check_enhancement_factors(self):
        for s in self.samplers:
            if ((s.s_enhance, s.t_enhance) != (self.s_enhance, self.t_enhance)
                    or tuple(s.hr_sample_shape) != tuple(self.sample_shape)):
                raise ValueError(
                    'All dual samplers in a queue must share the queue\'s '
                    f'enhancement ({self.s_enhance}, {self.t_enhance}) and '
                    f'one hr_sample_shape {tuple(self.sample_shape)}; got '
                    f'({s.s_enhance}, {s.t_enhance}) and '
                    f'{tuple(s.hr_sample_shape)}')

    @property
    def lr_shape(self):
        s = self.samplers[0]
        shp = (*s.lr_sample_shape, len(self.lr_features))
        return (shp[0], shp[1], shp[3]) if self._is_4d else shp

    @property
    def hr_shape(self):
        s = self.samplers[0]
        shp = (*s.hr_sample_shape, len(s.hr_features))
        return (shp[0], shp[1], shp[3]) if self._is_4d else shp

    def _stack(self, samples):
        """Samples are (lr, hr[, obs]) tuples: stack each member."""
        return tuple(np.stack(m, axis=0) for m in zip(*samples))

    def transform(self, samples, smoothing=None, smoothing_ignore=None):
        lr, hr = samples[0], samples[1]
        if smoothing is not None:
            lr = smooth_data(np.array(lr), self.lr_features,
                             smoothing_ignore or [], smoothing)
        if self._is_4d:
            lr, hr = lr[:, :, :, 0, :], hr[:, :, :, 0, :]
        return np.ascontiguousarray(lr), np.ascontiguousarray(hr)

    def post_proc(self, samples):
        if self._has_obs:
            lr, hr = self.transform(samples[:2], **self.transform_kwargs)
            obs = samples[2]
            if self._is_4d:
                obs = obs[:, :, :, 0, :]
            return BatchWithObs(low_res=lr, high_res=hr, obs=obs)
        lr, hr = self.transform(samples, **self.transform_kwargs)
        return Batch(low_res=lr, high_res=hr)



class ConditionalBatchQueue(SingleBatchQueue):
    """Queue for conditional-moment training: adds a padding-aware mask
    and a moment-specific output target (reference:
    batch_queues/conditional.py:22-170)."""

    def __init__(self, samplers, time_enhance_mode='constant',
                 lower_models=None, s_padding=0, t_padding=0,
                 end_t_padding=False, **kwargs):
        if kwargs.get('device_transform'):
            # post_proc always builds the mask and the moment target on
            # the host: the flag would be a silent no-op
            raise NotImplementedError(
                'Conditional-moment queues build the mask/output '
                'target on the host; device_transform=True is not '
                'supported here')
        self.time_enhance_mode = time_enhance_mode
        self.lower_models = lower_models or {}
        self.s_padding = s_padding
        self.t_padding = t_padding
        self.end_t_padding = end_t_padding
        super().__init__(samplers, **kwargs)

    def make_mask(self, high_res):
        """1 inside the (s_padding, t_padding)-trimmed interior, else 0;
        with ``end_t_padding`` the last ``t_enhance - 1`` HR steps are
        0 too."""
        mask = np.zeros(high_res.shape, dtype=high_res.dtype)
        s_min = self.s_padding
        t_min = self.t_padding
        s_max = None if self.s_padding == 0 else -self.s_padding
        t_max = None if self.t_padding == 0 else -self.t_padding
        if self.end_t_padding and self.t_enhance > 1:
            t_max = (1 - self.t_enhance if t_max is None
                     else 1 - self.t_enhance - self.t_padding)
        if high_res.ndim == 4:
            mask[:, s_min:s_max, s_min:s_max, :] = 1.0
        else:
            mask[:, s_min:s_max, s_min:s_max, t_min:t_max, :] = 1.0
        return mask

    def _enhanced_lr(self, lr):
        """The LR batch simple-enhanced back to the HR grid, HR features
        only (the subfilter targets' baseline)."""
        out = spatial_simple_enhancing(lr, s_enhance=self.s_enhance)
        out = temporal_simple_enhancing(out, t_enhance=self.t_enhance,
                                        mode=self.time_enhance_mode)
        return out[..., self.hr_features_ind]

    def _lower_model_output(self, lr, hr):
        """The first-moment model's prediction on this batch (normalized,
        with hr's exo channels), as host numpy."""
        return self.lower_models[1].batch_output(lr, hr)

    def make_output(self, samples):
        """Moment target; overridden per moment type."""
        _, hr = samples
        return hr

    def post_proc(self, samples):
        lr, hr = self.transform(samples, **self.transform_kwargs)
        mask = self.make_mask(hr)
        output = self.make_output((lr, hr))
        return ConditionalBatch(low_res=lr, high_res=hr, output=output,
                                mask=mask)


class QueueMom1(ConditionalBatchQueue):
    """First moment: target = HR."""


class QueueMom1SF(ConditionalBatchQueue):
    """First moment of subfilter: target = HR - enhanced(LR)."""

    def make_output(self, samples):
        lr, hr = samples
        return hr - self._enhanced_lr(lr)


class QueueMom2(ConditionalBatchQueue):
    """Second moment: target = (HR - <HR|LR>)^2."""

    def make_output(self, samples):
        lr, hr = samples
        return (hr - self._lower_model_output(lr, hr)) ** 2


class QueueMom2Sep(QueueMom1):
    """Second moment, separate: target = HR^2."""

    def make_output(self, samples):
        return super().make_output(samples) ** 2


class QueueMom2SF(ConditionalBatchQueue):
    """Second moment of subfilter: (HR - LR_enh - <SF|LR>)^2."""

    def make_output(self, samples):
        lr, hr = samples
        out = self._lower_model_output(lr, hr)
        return (hr - self._enhanced_lr(lr) - out) ** 2


class QueueMom2SepSF(QueueMom1SF):
    """Second moment of subfilter, separate: (HR - LR_enh)^2."""

    def make_output(self, samples):
        return super().make_output(samples) ** 2


class BatchQueueDC(SingleBatchQueue):
    """Data-centric queue: its samplers draw from loss-adaptive bins
    (reference: batch_queues/dc.py:13)."""

    def __init__(self, samplers, n_space_bins=1, n_time_bins=1, **kwargs):
        self.n_space_bins = n_space_bins
        self.n_time_bins = n_time_bins
        self._spatial_weights = np.ones(n_space_bins) / n_space_bins
        self._temporal_weights = np.ones(n_time_bins) / n_time_bins
        super().__init__(samplers, **kwargs)
        self.update_weights(self._spatial_weights, self._temporal_weights)

    @property
    def spatial_weights(self):
        """Current spatial bin weights."""
        return self._spatial_weights

    @property
    def temporal_weights(self):
        """Current temporal bin weights."""
        return self._temporal_weights

    def update_weights(self, spatial_weights, temporal_weights):
        """Push new bin weights into every sampler."""
        self._spatial_weights = np.asarray(spatial_weights)
        self._temporal_weights = np.asarray(temporal_weights)
        for s in self.samplers:
            s.update_weights(self._spatial_weights, self._temporal_weights)


class ValBatchQueueDC(BatchQueueDC):
    """Validation queue of one batch per spatiotemporal bin, so each
    bin's loss can be measured (reference: batch_queues/dc.py:69). Batch
    ``i`` is bin (``i % n_space_bins``, ``(i // n_space_bins) %
    n_time_bins``); production is serial (one worker), since each batch
    sets every sampler's weights to its own bin. ``stop`` drops the
    batches made ahead, so it waits for the one in production and starts
    the count again: the next batch served is bin (0, 0)."""

    def __init__(self, samplers, n_space_bins=1, n_time_bins=1, **kwargs):
        kwargs['n_batches'] = n_space_bins * n_time_bins
        kwargs['max_workers'] = 1
        super().__init__(samplers, n_space_bins=n_space_bins,
                         n_time_bins=n_time_bins, **kwargs)
        self._batch_counter = 0

    def sample_batch(self):
        """All the weight on the current batch's bin."""
        i = self._batch_counter
        s_w = np.zeros(self.n_space_bins)
        s_w[i % self.n_space_bins] = 1
        t_w = np.zeros(self.n_time_bins)
        t_w[i // self.n_space_bins % self.n_time_bins] = 1
        self.update_weights(s_w, t_w)
        self._batch_counter = i + 1
        return super().sample_batch()

    def stop(self):
        pool = self._pool
        super().stop()
        if pool is not None:
            pool.shutdown(wait=True)
        self._batch_counter = 0
