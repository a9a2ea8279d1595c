"""The port's training feed against the JAX package's: the same seed
gives the same fake data, sample indices, batches and (lr, hr) pairs
(``Sampler``, ``SingleBatchQueue.sample_batch`` / ``transform`` called
single-threaded after both packages' ``RANDOM_GENERATOR`` facades are
reseeded), the device transform gives the host transform's pair, and
``StatsCollection`` the same means and stds. Tolerance rtol 1e-6 (the
same float32 block means in another order)."""

import json

import numpy as np
import pytest
import torch

from sup3r_tpu.preprocessing.batch_queues import (
    SingleBatchQueue as JaxQueue,
)
from sup3r_tpu.preprocessing import samplers as jax_samplers
from sup3r_tpu.preprocessing.samplers import Sampler as JaxSampler
from sup3r_tpu.preprocessing.stats import StatsCollection as JaxStats
from sup3r_tpu.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu.utilities.test_helpers import make_fake_dset as jax_dset
from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.preprocessing import (
    BatchHandler,
    RawBatch,
    Sampler,
    SingleBatchQueue,
    StatsCollection,
)
from sup3r_tpu_torch.preprocessing import samplers
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.utilities.test_helpers import make_fake_dset

torch.set_num_threads(1)

FEATURES = ['u_100m', 'v_100m', 'topography']


def _reseed(seed):
    for rng in (RANDOM_GENERATOR, JAX_RNG):
        rng.bit_generator.state = np.random.default_rng(
            seed).bit_generator.state


def _both_dsets(shape, features=FEATURES):
    _reseed(0)
    port = make_fake_dset(shape, features)
    jax = jax_dset(shape, features)
    np.testing.assert_array_equal(port.data, jax.data)
    np.testing.assert_array_equal(port.lat_lon, jax.lat_lon)
    assert [str(t) for t in np.asarray(port.time_index)] == [
        str(t) for t in np.asarray(jax.time_index, dtype='datetime64[ns]')]
    return port, jax


@pytest.mark.parametrize('sample_shape', [(8, 6, 12), (10, 10, 1)])
def test_sampler_draws_the_jax_samples(sample_shape):
    port, jax = _both_dsets((20, 16, 40))
    sets = {'hr_exo_features': ['topography']}
    ps = Sampler(port, sample_shape, feature_sets=sets)
    js = JaxSampler(jax, sample_shape, feature_sets=sets)
    for attr in ('lr_features', 'hr_features', 'hr_exo_features',
                 'hr_out_features', 'hr_features_ind'):
        assert getattr(ps, attr) == getattr(js, attr), attr
    _reseed(7)
    for _ in range(5):
        assert ps.get_sample_index() == js.get_sample_index()
        np.testing.assert_array_equal(next(ps), next(js))


def test_weighted_samplers_draw_the_jax_slices():
    _reseed(3)
    for _ in range(4):
        for name, args in (
                ('weighted_box_sampler', ((20, 16, 40), (8, 6),
                                          [0.1, 0.5, 0.0, 2.0])),
                ('weighted_time_sampler', ((20, 16, 40), 12,
                                           [1.0, np.nan, 3.0])),
                ('uniform_time_sampler', ((20, 16, 40), 12,
                                          slice(4, 30)))):
            got = getattr(samplers, name)(*args)
            assert got == getattr(jax_samplers, name)(*args), name


@pytest.mark.parametrize('kwargs', [
    dict(s_enhance=2, t_enhance=4, sample_shape=(8, 6, 12),
         transform_kwargs={'temporal_coarsening_method': 'average'}),
    dict(s_enhance=3, t_enhance=2, sample_shape=(6, 9, 8),
         transform_kwargs={'temporal_coarsening_method': 'subsample',
                           'smoothing': 0.6,
                           'smoothing_ignore': ['topography']}),
    dict(s_enhance=2, t_enhance=1, sample_shape=(8, 8, 1)),
])
def test_queue_batches_match_jax(kwargs):
    kwargs = dict(kwargs)
    sample_shape = kwargs.pop('sample_shape')
    port, jax = _both_dsets((20, 18, 40))
    port2, jax2 = _both_dsets((12, 12, 24))
    sets = {'lr_only_features': ['topography']}
    pq = SingleBatchQueue([Sampler(d, sample_shape, feature_sets=sets)
                           for d in (port, port2)], batch_size=3, **kwargs)
    jq = JaxQueue([JaxSampler(d, sample_shape, feature_sets=sets)
                   for d in (jax, jax2)], batch_size=3, **kwargs)
    assert (pq.lr_shape, pq.hr_shape) == (jq.lr_shape, jq.hr_shape)
    assert pq.transform_config == jq.transform_config
    _reseed(11)
    for _ in range(3):
        samples = pq.sample_batch()
        np.testing.assert_array_equal(samples, jq.sample_batch())
        got = pq.post_proc(samples)
        want = jq.post_proc(samples)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_device_transform_gives_the_host_pair():
    port, _ = _both_dsets((20, 18, 40))
    kw = dict(batch_size=3, s_enhance=2, t_enhance=4,
              transform_kwargs={'temporal_coarsening_method': 'average'})
    sets = {'lr_only_features': ['topography']}
    host = SingleBatchQueue([Sampler(port, (8, 6, 12), feature_sets=sets)],
                            **kw)
    dev = SingleBatchQueue([Sampler(port, (8, 6, 12), feature_sets=sets)],
                           device_transform=True, **kw)
    samples = host.sample_batch()
    raw = dev.post_proc(samples)
    assert isinstance(raw, RawBatch)
    model = Sup3rGan(generator_st(2, (2,), (4,), filters=8, n_resblocks=1),
                     [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}],
                     device='cpu')
    model._sample_transform = dev.transform_config
    lr, hr = model._split_sample(torch.from_numpy(raw.sample))
    want_lr, want_hr = host.post_proc(samples)
    np.testing.assert_allclose(lr.numpy(), want_lr, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(hr.numpy(), want_hr)


def test_handler_iterates_tensors_and_counts_starvation():
    train, _ = _both_dsets((20, 18, 40), ['u_100m', 'v_100m'])
    handler = BatchHandler([train], batch_size=2, n_batches=3,
                           s_enhance=2, t_enhance=2, sample_shape=(8, 8, 8),
                           device='cpu')
    batches = list(handler)
    handler.stop()
    assert len(batches) == 3
    assert all(isinstance(b.low_res, torch.Tensor)
               and b.low_res.shape == (2, 4, 4, 4, 2)
               and b.high_res.shape == (2, 8, 8, 8, 2) for b in batches)
    assert 0.0 <= handler._queue.starvation_rate <= 1.0


@pytest.mark.filterwarnings(
    'ignore::pytest.PytestUnhandledThreadExceptionWarning')
def test_dead_producer_raises():
    train, _ = _both_dsets((20, 18, 40), ['u_100m', 'v_100m'])
    handler = BatchHandler([train], batch_size=2, n_batches=2,
                           s_enhance=2, sample_shape=(8, 8, 1),
                           device='cpu')

    def broken(samples):
        raise RuntimeError('broken transform')

    handler._queue.post_proc = broken
    with pytest.raises(RuntimeError, match='producer thread died'):
        list(handler)
    handler.stop()


def test_stats_match_jax(tmp_path):
    port, jax = _both_dsets((20, 18, 40))
    port2, jax2 = _both_dsets((12, 10, 24))
    means_file = str(tmp_path / 'means.json')
    stds = {'u_100m': 2.0}
    with pytest.warns(UserWarning, match='computing the missing'):
        ps = StatsCollection([port, port2], means=means_file,
                             stds=dict(stds))
    with pytest.warns(UserWarning, match='computing the missing'):
        js = JaxStats([jax, jax2], means=None, stds=dict(stds))
    assert sorted(ps.means) == sorted(js.means) == sorted(FEATURES)
    for f in FEATURES:
        np.testing.assert_allclose(ps.means[f], js.means[f], rtol=1e-6)
        np.testing.assert_allclose(ps.stds[f], js.stds[f], rtol=1e-6)
    with open(means_file) as f:
        assert json.load(f) == ps.means
    np.testing.assert_allclose(port.data, jax.data, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port2.data, jax2.data, rtol=1e-6, atol=1e-6)
