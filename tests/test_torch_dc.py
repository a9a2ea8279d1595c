"""The port's data-centric training (``Sup3rGanDC``, ``BatchHandlerDC``,
``BatchQueueDC`` / ``ValBatchQueueDC``, ``SamplerDC``) against the JAX
package's on the CPU.

- ``SamplerDC``'s crops under a seeded ``RANDOM_GENERATOR`` equal the JAX
  sampler's (both draw from their package's shared numpy generator in
  the same order);
- the validation queue emits bin (``i % n_s``, ``(i // n_s) % n_t``) for
  batch ``i``, serially (trap 5), with the JAX queue's batches;
- the per-bin losses of ``calc_val_loss_gen`` on the same weights and
  batches, and the bin-weight update from given per-bin losses, equal
  the JAX package's (rtol 1e-4, the repository's fp32 parity bar);
- tests/training/test_train_gan_dc.py's four bin settings train in the
  port with the weights a probability vector that moves off uniform.
"""

from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sup3r_tpu.models import Sup3rGanDC as JaxGanDC
from sup3r_tpu.preprocessing.batch_handlers import (
    BatchHandlerDC as JaxHandlerDC,
)
from sup3r_tpu.preprocessing.batch_queues import (
    ValBatchQueueDC as JaxValQueue,
)
from sup3r_tpu.preprocessing.samplers import SamplerDC as JaxSamplerDC
from sup3r_tpu.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu.utilities.test_helpers import make_fake_dset as jax_dset
from sup3r_tpu_torch.models import Sup3rGanDC
from sup3r_tpu_torch.models.weights import params_to_jax
from sup3r_tpu_torch.preprocessing import (
    BatchHandlerDC,
    SamplerDC,
    ValBatchQueueDC,
)
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.utilities.test_helpers import make_fake_dset
from tests.training import test_train_gan_dc as jax_dc

torch.set_num_threads(1)

RTOL = 1e-4
FEATURES = ['u_100m', 'v_100m']


def _reseed(seed):
    for rng in (RANDOM_GENERATOR, JAX_RNG):
        rng.bit_generator.state = np.random.default_rng(
            seed).bit_generator.state


def _dsets(shape, seed=0):
    """The same fake dataset in each package (each drawn from its own
    shared generator, reseeded alike)."""
    _reseed(seed)
    return make_fake_dset(shape, FEATURES), jax_dset(shape, FEATURES)


@pytest.mark.parametrize('s_w,t_w', [
    (None, None), ([0.1, 0.2, 0.3, 0.4], [0.5, 0.5]),
    ([0, 0, 1, 0], [0, 1]), ([1.0], [np.nan, 2.0, 0.0])])
def test_sampler_dc_draws_match_jax(s_w, t_w):
    port_d, jax_d = _dsets((20, 18, 30))
    samplers = [cls(d, sample_shape=(8, 6, 4), spatial_weights=s_w,
                    temporal_weights=t_w)
                for cls, d in ((SamplerDC, port_d), (JaxSamplerDC, jax_d))]
    _reseed(3)
    got = [samplers[0].get_sample_index() for _ in range(20)]
    _reseed(3)
    want = [samplers[1].get_sample_index() for _ in range(20)]
    assert got == want
    _reseed(4)
    sample = next(samplers[0])
    _reseed(4)
    np.testing.assert_array_equal(sample, next(samplers[1]))


def _val_queues(n_s, n_t):
    port_d, jax_d = _dsets((16, 16, 24), seed=1)
    kw = dict(batch_size=2, s_enhance=2, t_enhance=1, n_space_bins=n_s,
              n_time_bins=n_t)
    return (ValBatchQueueDC([SamplerDC(port_d, sample_shape=(4, 4, 2))],
                            **kw),
            JaxValQueue([JaxSamplerDC(jax_d, sample_shape=(4, 4, 2))],
                        **kw))


@pytest.mark.parametrize('n_s,n_t', [(2, 3), (4, 1), (1, 4)])
def test_val_queue_dc_order(n_s, n_t):
    """Trap 5: batch i is bin (i % n_s, (i // n_s) % n_t), one worker,
    each batch drawn from its bin alone; the JAX queue gives the same
    batches under the same seed."""
    port_q, jax_q = _val_queues(n_s, n_t)
    assert port_q.n_batches == n_s * n_t and port_q.max_workers == 1
    _reseed(5)
    got = []
    for i in range(2 * n_s * n_t):
        batch = port_q.post_proc(port_q.sample_batch())
        s_w, t_w = port_q.spatial_weights, port_q.temporal_weights
        assert s_w[i % n_s] == 1 and s_w.sum() == 1
        assert t_w[(i // n_s) % n_t] == 1 and t_w.sum() == 1
        got.append(batch)
    _reseed(5)
    for batch in got:
        want = jax_q.post_proc(jax_q.sample_batch())
        np.testing.assert_array_equal(batch.high_res, want.high_res)
        np.testing.assert_allclose(batch.low_res, want.low_res, rtol=1e-6)
    # served in that order through the producer thread too, and from bin
    # (0, 0) again after a stop (which drops the batches made ahead)
    port_q, _ = _val_queues(n_s, n_t)
    _reseed(5)
    served = list(port_q)
    port_q.stop()
    assert port_q._batch_counter == 0
    for batch, want in zip(served, got[:n_s * n_t]):
        np.testing.assert_array_equal(batch.high_res, want.high_res)
    list(port_q)
    port_q.stop()
    assert port_q._batch_counter == 0
    port_q.sample_batch()
    assert port_q.spatial_weights[0] == port_q.temporal_weights[0] == 1


def _model_pair():
    port = Sup3rGanDC(jax_dc._gen(False), jax_dc._disc(False),
                      learning_rate=5e-3, device='cpu')
    port.init_weights((1, 4, 4, 2), (1, 8, 8, 2), seed=0)
    jax_model = JaxGanDC(jax_dc._gen(False), jax_dc._disc(False),
                         learning_rate=5e-3)
    jax_model.init_weights((1, 4, 4, 2), (1, 8, 8, 2))
    jax_model.gen_params = jax.tree.map(jnp.asarray,
                                        params_to_jax(port._gen))
    jax_model.disc_params = jax.tree.map(jnp.asarray,
                                         params_to_jax(port._disc))
    return port, jax_model


class _Handler:
    """A stand-in batch handler: given validation batches and a record of
    the weights pushed to it."""

    def __init__(self, batches, n_s, n_t):
        self.val_data = batches
        self.n_space_bins, self.n_time_bins = n_s, n_t
        self.pushed = None

    def update_weights(self, spatial_weights, temporal_weights):
        self.pushed = (np.asarray(spatial_weights),
                       np.asarray(temporal_weights))


def test_per_bin_losses_and_weight_update_match_jax():
    port, jax_model = _model_pair()
    rng = np.random.default_rng(2)
    n_s, n_t = 3, 2
    batch = namedtuple('Batch', ['low_res', 'high_res'])
    batches = [batch(rng.random((2, 4, 4, 2)).astype(np.float32),
                     rng.random((2, 8, 8, 2)).astype(np.float32))
               for _ in range(n_s * n_t)]
    handlers = [_Handler(batches, n_s, n_t) for _ in range(2)]
    got = port.calc_val_loss_gen(handlers[0], 1e-3)
    want = jax_model.calc_val_loss_gen(handlers[1], 1e-3)
    for g, w in zip(got, want):
        assert g.shape == (n_s, n_t) and (g > 0).all()
        np.testing.assert_allclose(g, w, rtol=RTOL)
    out = port.calc_val_loss(handlers[0], 1e-3)
    want_out = jax_model.calc_val_loss(handlers[1], 1e-3)
    assert sorted(out) == sorted(want_out)
    for key in want_out:
        np.testing.assert_allclose(out[key], want_out[key], rtol=RTOL)
    for g, w in zip(handlers[0].pushed, handlers[1].pushed):
        np.testing.assert_allclose(g, w, rtol=RTOL)
        np.testing.assert_allclose(g.sum(), 1.0, rtol=1e-6)


def test_weight_update_from_given_losses_matches_jax(monkeypatch):
    """The update alone, from the same given per-bin losses."""
    port, jax_model = _model_pair()
    total = np.array([[1.0, 2.0], [3.0, 0.5], [0.25, 4.0]], np.float32)
    content = total / 2
    handlers = [_Handler([None] * 6, 3, 2) for _ in range(2)]
    for model, handler in ((port, handlers[0]), (jax_model, handlers[1])):
        monkeypatch.setattr(model, 'calc_val_loss_gen',
                            lambda h, w: (total, content))
        out = model.calc_val_loss(handler, 1e-3)
        assert out['val_loss_gen'] == pytest.approx(total.mean())
    for g, w in zip(handlers[0].pushed, handlers[1].pushed):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(handlers[0].pushed[0],
                               total.mean(axis=1) / total.mean(axis=1).sum())


def test_calc_loss_matches_jax():
    port, jax_model = _model_pair()
    rng = np.random.default_rng(4)
    hr = rng.random((2, 8, 8, 2)).astype(np.float32)
    out = rng.random((2, 8, 8, 2)).astype(np.float32)
    for kw in ({'train_gen': True, 'compute_disc': True},
               {'train_gen': False, 'train_disc': True}):
        loss, details = port.calc_loss(hr, out, **kw)
        want_loss, want = jax_model.calc_loss(hr, out, **kw)
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
        assert sorted(details) == sorted(want)
        for key in want:
            np.testing.assert_allclose(float(details[key]),
                                       float(want[key]), rtol=RTOL)
    with pytest.raises(RuntimeError, match='enhancement'):
        port.calc_loss(hr, out[:, :4])


@pytest.mark.parametrize(('n_space_bins', 'n_time_bins', 'st'), [
    (4, 1, False), (1, 4, True), (4, 4, True), (2, 2, True)])
def test_train_gan_dc_bins(n_space_bins, n_time_bins, st):
    """test_train_gan_dc.py::test_train_gan_dc_bins in the port."""
    t_enhance = 2 if st else 1
    sample_shape = (8, 8, 4) if st else (8, 8, 1)
    handler = BatchHandlerDC(
        [make_fake_dset((20, 20, 60), FEATURES)],
        [make_fake_dset((20, 20, 60), FEATURES)],
        batch_size=2, n_batches=2, s_enhance=2, t_enhance=t_enhance,
        sample_shape=sample_shape, n_space_bins=n_space_bins,
        n_time_bins=n_time_bins)
    assert len(handler.spatial_weights) == n_space_bins
    assert len(handler.temporal_weights) == n_time_bins
    model = Sup3rGanDC(jax_dc._gen(st), jax_dc._disc(st),
                       learning_rate=5e-3, device='cpu')
    model.train(handler, input_resolution={'spatial': '30km',
                                           'temporal': '60min'},
                n_epoch=2, out_dir=None)
    assert len(model.history) == 2
    assert np.isfinite(model.history['val_loss_gen']).all()
    for weights, n in ((handler.spatial_weights, n_space_bins),
                       (handler.temporal_weights, n_time_bins)):
        np.testing.assert_allclose(np.sum(weights), 1.0, rtol=1e-5)
        assert (np.asarray(weights) >= 0).all()
        if n > 1:
            assert not np.allclose(weights, 1.0 / n)
    assert model.meta['class'] == 'Sup3rGanDC'
    handler.stop()


def test_batch_handler_dc_checks():
    """Validation data required; more bins than sample starts refused
    at construction, as the JAX handler does."""
    features = ['u_100m', 'v_100m', 'topography']
    for Handler in (BatchHandlerDC, JaxHandlerDC):
        with pytest.raises(ValueError, match='validation'):
            Handler([make_fake_dset((20, 20, 48), FEATURES)],
                    sample_shape=(8, 8, 4))
        with pytest.raises(ValueError, match='too large'):
            Handler([make_fake_dset((20, 20, 48), features)],
                    [make_fake_dset((20, 20, 48), features)],
                    batch_size=2, n_batches=1, s_enhance=2, t_enhance=1,
                    sample_shape=(20, 20, 8), n_space_bins=4,
                    n_time_bins=4,
                    feature_sets={'hr_exo_features': ['topography']})


def test_save_load_across_packages(tmp_path):
    """A ``Sup3rGanDC`` checkpoint of either package loads in the other
    as that class, with the same generator output."""
    port, jax_model = _model_pair()
    port.save(str(tmp_path / 'port'))
    jax_model.save(str(tmp_path / 'jax'))
    lr = np.random.default_rng(6).random((1, 4, 4, 2)).astype(np.float32)
    from_jax = Sup3rGanDC.load(str(tmp_path / 'jax'), device='cpu')
    to_jax = JaxGanDC.load(str(tmp_path / 'port'))
    assert type(from_jax) is Sup3rGanDC and type(to_jax) is JaxGanDC
    want = jax_model.generate(lr)
    for got in (from_jax.generate(lr), to_jax.generate(lr)):
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
