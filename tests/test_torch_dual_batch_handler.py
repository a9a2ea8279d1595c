"""The port's paired-data feed against the JAX package's on the same fake
LR / HR data and the same ``RANDOM_GENERATOR`` seed: ``PairedDataset``,
``DualRasterizer`` (HR trim, coarsened HR coords, the IDW k=4 regrid
within 1e-6 relative), the stats of a paired container, ``DualSampler``
(identical sample indices), ``DualBatchQueue`` (batches within 1e-6) and
``DualBatchHandler`` feeding two epochs of ``Sup3rGan.train`` (losses
within rtol 1e-4 of the JAX package's, from the same weights, with Adam
epsilon 1 as tests/test_torch_train_step.py explains)."""

import jax
import numpy as np
import pytest
import torch

import sup3r_tpu.preprocessing.batch_handlers as jax_bh
import sup3r_tpu.preprocessing.batch_queues as jax_bq
import sup3r_tpu.preprocessing.samplers as jax_samplers
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.preprocessing.rasterizers import (
    DualRasterizer as JaxDualRasterizer,
)
from sup3r_tpu.preprocessing.stats import (
    StatsCollection as JaxStatsCollection,
)
from sup3r_tpu.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu.utilities.test_helpers import make_fake_dset as jax_fake_dset
from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.weights import params_from_jax
from sup3r_tpu_torch.preprocessing import (
    DualBatchHandler,
    DualBatchQueue,
    DualRasterizer,
    DualSampler,
    PairedDataset,
)
from sup3r_tpu_torch.preprocessing.stats import StatsCollection
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.utilities.test_helpers import make_fake_dset
from test_torch_train_step import STEP_OPT

torch.set_num_threads(1)

FEATURES = ['u_100m', 'v_100m']
RES = {'spatial': '30km', 'temporal': '60min'}


def _reseed(seed):
    for rng in (RANDOM_GENERATOR, JAX_RNG):
        rng.bit_generator.state = np.random.default_rng(
            seed).bit_generator.state


def _lr_hr(package, hr_shape=(25, 24, 17), lr_shape=(14, 13, 9),
           t_enhance=2):
    """A fake HR dataset (not enhancement-divisible, so the rasterizer
    trims it) and an LR one on a coarser, offset grid with a step of
    ``t_enhance`` hours, drawn from the package's generator after a
    reseed."""
    fake = make_fake_dset if package == 'port' else jax_fake_dset
    _reseed(7)
    hr = fake(hr_shape, FEATURES)
    lr = fake(lr_shape, FEATURES, lat_range=(40.1, 38.9),
              lon_range=(-105.6, -104.2), freq=f'{t_enhance}h')
    return lr, hr


def _rasterized(package, s_enhance=2, t_enhance=2):
    lr, hr = _lr_hr(package, lr_shape=(14, 13, 17 // t_enhance + 1),
                    t_enhance=t_enhance)
    cls = DualRasterizer if package == 'port' else JaxDualRasterizer
    return cls({'low_res': lr, 'high_res': hr}, s_enhance=s_enhance,
               t_enhance=t_enhance)


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def test_paired_dataset():
    lr, hr = _lr_hr('port')
    pair = PairedDataset(low_res=lr, high_res=hr)
    assert pair['low_res'] is lr and pair.high_res is hr and pair[1] is hr
    assert list(pair) == [lr, hr] and len(pair) == 2
    assert pair.shape == hr.shape
    assert pair.size == lr.size + hr.size
    assert pair.features == FEATURES
    assert pair.mean() == hr.mean() and pair.std() == hr.std()


def test_dual_rasterizer_matches_jax():
    port, jax_dual = _rasterized('port'), _rasterized('jax')
    assert port.hr_data.shape == jax_dual.hr_data.shape == (24, 24, 16, 2)
    assert port.lr_data.shape == jax_dual.lr_data.shape == (12, 12, 8, 2)
    np.testing.assert_array_equal(port.hr_data.data, jax_dual.hr_data.data)
    np.testing.assert_array_equal(port.lr_data.lat_lon,
                                  jax_dual.lr_data.lat_lon)
    assert port.lr_data.time_index.equals(
        np.asarray(jax_dual.lr_data.time_index, 'datetime64[ns]'))
    assert not np.isnan(port.lr_data.data).any()
    assert _rel(port.lr_data.data, jax_dual.lr_data.data) <= 1e-6
    assert isinstance(port.data, PairedDataset)
    assert port.data.low_res is port.lr_data


def test_dual_rasterizer_exact_match_and_nan_fill():
    """A target that sits on a source point takes that source's value
    (no IDW blur), and NaNs in the regridded LR are filled, as in the
    JAX package."""
    out = {}
    for package in ('port', 'jax'):
        lr, hr = _lr_hr(package, hr_shape=(8, 8, 4), lr_shape=(4, 4, 2))
        # the LR grid at the coarsened HR coordinates exactly
        lr.lat_lon = (hr.lat_lon.reshape(4, 2, 4, 2, 2).mean(axis=(1, 3))
                      .astype(np.float32))
        lr.data[1, 2, 0, 0] = np.nan
        cls = DualRasterizer if package == 'port' else JaxDualRasterizer
        out[package] = cls((lr, hr), s_enhance=2, t_enhance=2).lr_data.data
        np.testing.assert_allclose(out[package][0, 0], lr.data[0, 0, :2],
                                   rtol=1e-6)
    assert not np.isnan(out['port']).any()
    assert _rel(out['port'], out['jax']) <= 1e-6


def test_paired_stats_match_jax():
    """Means and stds of a paired container come from its high-res
    member; every member is normalized."""
    port, jax_dual = _rasterized('port'), _rasterized('jax')
    mine = StatsCollection([port])
    theirs = JaxStatsCollection([jax_dual])
    for f in FEATURES:
        np.testing.assert_allclose(mine.means[f], theirs.means[f],
                                   rtol=1e-6)
        np.testing.assert_allclose(mine.stds[f], theirs.stds[f], rtol=1e-6)
    assert _rel(port.hr_data.data, jax_dual.hr_data.data) <= 1e-6
    assert _rel(port.lr_data.data, jax_dual.lr_data.data) <= 1e-6


def _samplers(sample_shape=(8, 8, 4), **kwargs):
    port, jax_dual = _rasterized('port'), _rasterized('jax')
    return (DualSampler(port.data, sample_shape, s_enhance=2, t_enhance=2,
                        **kwargs),
            jax_samplers.DualSampler(jax_dual.data, sample_shape,
                                     s_enhance=2, t_enhance=2, **kwargs))


def test_dual_sampler_indices_equal_jax():
    port, jax_s = _samplers()
    assert port.lr_sample_shape == jax_s.lr_sample_shape == (4, 4, 2)
    assert port.features == jax_s.features
    assert port.hr_out_features == jax_s.hr_out_features
    _reseed(11)
    for _ in range(20):
        lr_idx, hr_idx = port.get_sample_index()
        assert (lr_idx, hr_idx) == jax_s.get_sample_index()
        lr, hr = port.lr_data.sample(lr_idx), port.hr_data.sample(hr_idx)
        assert lr.shape == (4, 4, 2, 2) and hr.shape == (8, 8, 4, 2)


def test_dual_sampler_feature_sets():
    port, jax_s = _samplers(feature_sets={'lr_only_features': ['v_100m']})
    assert port.hr_features == jax_s.hr_features == ['u_100m']
    assert port.lr_features == jax_s.lr_features == FEATURES


@pytest.mark.parametrize('sample_shape,t_enhance', [((8, 8, 4), 2),
                                                    ((8, 8, 1), 1)])
def test_dual_batch_queue_matches_jax(sample_shape, t_enhance):
    port, jax_dual = (_rasterized(p, t_enhance=t_enhance)
                      for p in ('port', 'jax'))
    kw = dict(batch_size=3, n_batches=2, s_enhance=2, t_enhance=t_enhance)
    queue = DualBatchQueue([DualSampler(port.data, sample_shape,
                                        s_enhance=2, t_enhance=t_enhance)],
                           **kw)
    jax_queue = jax_bq.DualBatchQueue(
        [jax_samplers.DualSampler(jax_dual.data, sample_shape, s_enhance=2,
                                  t_enhance=t_enhance)], **kw)
    assert queue.lr_shape == jax_queue.lr_shape
    assert queue.hr_shape == jax_queue.hr_shape
    _reseed(12)
    for _ in range(3):
        got = queue.post_proc(queue.sample_batch())
        want = jax_queue.post_proc(jax_queue.sample_batch())
        assert type(got).__name__ == 'Batch'
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert _rel(g, w) <= 1e-6


def _handlers(package):
    dual = _rasterized(package)
    val = _rasterized(package)
    cls = DualBatchHandler if package == 'port' else jax_bh.DualBatchHandler
    return cls([dual], [val], batch_size=2, n_batches=2, s_enhance=2,
               t_enhance=2, sample_shape=(8, 8, 4))


def test_dual_batch_handler_batches_match_jax():
    _reseed(13)
    port = _handlers('port')
    jax_handler = _handlers('jax')
    assert port.means == pytest.approx(jax_handler.means, rel=1e-6)
    assert port.lr_shape == jax_handler.lr_shape == (4, 4, 2, 2)
    assert port.hr_shape == jax_handler.hr_shape == (8, 8, 4, 2)
    _reseed(14)
    got = [next(port) for _ in range(2)]
    port.stop()
    _reseed(14)
    want = [next(jax_handler) for _ in range(2)]
    jax_handler.stop()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert _rel(np.asarray(a), np.asarray(b)) <= 1e-6


def _fixed_val_batches(handler):
    """Draw the handler's validation batches now, in this thread, and
    make them its validation data: the training and validation producers
    of both packages draw from one RANDOM_GENERATOR, so with both threads
    running the draws would follow the threads' interleaving (ROADMAP
    queue 3, reference behaviour 4); with the validation batches fixed
    before training starts, the training producer draws alone."""
    queue = handler.val_data
    handler.val_data = [queue.post_proc(queue.sample_batch())
                        for _ in range(len(queue))]


def test_train_over_dual_batch_handler_matches_jax():
    """Two epochs of ``Sup3rGan.train`` over a DualBatchHandler (batches
    staged on the model's device by the handler) give the JAX package's
    losses from the same weights and the same batches (the validation
    batches drawn before training, ``_fixed_val_batches``)."""
    gen = generator_st(2, (2,), (2,), filters=8, n_resblocks=1)
    disc = {'hidden_layers': [
        {'class': 'Conv3D', 'filters': 8, 'kernel_size': 3, 'strides': 2,
         'padding': 'same'},
        {'class': 'LeakyReLU', 'alpha': 0.2},
        {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]}
    histories = {}
    start = None
    for package in ('jax', 'port'):
        handler = _handlers(package)
        _reseed(15)
        _fixed_val_batches(handler)
        if package == 'jax':
            model = JaxGan(gen, disc, optimizer=STEP_OPT)
            model.init_weights((1, 4, 4, 2, 2), (1, 8, 8, 4, 2))
            start = [jax.tree.map(np.asarray, p)
                     for p in (model.gen_params, model.disc_params)]
        else:
            model = Sup3rGan(gen, disc, optimizer=STEP_OPT, device='cpu')
            model.init_weights((1, 4, 4, 2, 2), (1, 8, 8, 4, 2))
            params_from_jax(model.generator, start[0])
            params_from_jax(model.discriminator, start[1])
        model.train(handler, input_resolution=RES, n_epoch=2,
                    weight_gen_advers=1e-3, out_dir=None)
        handler.stop()
        histories[package] = model.history
    port, jax_hist = histories['port'], histories['jax']
    assert len(port) == 2
    for col in ('train_loss_gen', 'train_loss_disc', 'val_loss_gen',
                'val_loss_disc', 'train_disc_train_frac'):
        np.testing.assert_allclose(np.asarray(port[col], float),
                                   jax_hist[col].to_numpy(dtype=float),
                                   rtol=1e-4, err_msg=col)


def test_dual_inputs_are_checked():
    """Sample shapes the enhancement does not divide, LR / HR data the
    enhancement does not pair, and samplers that disagree with their
    queue raise."""
    data = _rasterized('port').data
    with pytest.raises(ValueError, match='not divisible'):
        DualSampler(data, (9, 8, 4), s_enhance=2, t_enhance=2)
    with pytest.raises(ValueError, match='inconsistent'):
        DualSampler(data, (12, 12, 4), s_enhance=3, t_enhance=2)
    samplers = [DualSampler(data, shape, s_enhance=2, t_enhance=2)
                for shape in ((8, 8, 4), (4, 4, 4))]
    with pytest.raises(ValueError, match='hr_sample_shape'):
        DualBatchQueue(samplers, s_enhance=2, t_enhance=2)
    with pytest.raises(ValueError, match='enhancement'):
        DualBatchQueue(samplers[:1], s_enhance=2, t_enhance=1)
