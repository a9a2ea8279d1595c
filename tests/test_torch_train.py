"""The port's GAN training loop (``Sup3rGan.train``) as
tests/training/test_train_gan.py checks the JAX package's: history,
gating, early stopping, resume, optimizer updates, the options not
ported yet; and save directories (weights, ``opt_state.msgpack``,
``history.csv``) that resume in either package with the same next step
(rtol 1e-4, as tests/test_torch_train_step.py holds the step)."""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from sup3r_tpu.configs import get_config
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.preprocessing import BatchHandler as JaxBatchHandler
from sup3r_tpu.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu.utilities.test_helpers import make_fake_dset as jax_fake_dset
from sup3r_tpu_torch.configs import generator_spatial, generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.record import Record
from sup3r_tpu_torch.models.weights import moments_to_jax, params_to_jax
from sup3r_tpu_torch.parallel import get_mesh, get_mesh_2d
from sup3r_tpu_torch.preprocessing import BatchHandler
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.utilities.test_helpers import make_fake_dset
from test_torch_train_step import (
    RTOL,
    STEP_OPT,
    _close,
    _compare_networks,
    _numpy_params,
)

torch.set_num_threads(1)

RES = {'spatial': '30km', 'temporal': '60min'}


# ----------------------------------------------------------------------
# train(), as tests/training/test_train_gan.py checks it
def _handler(s_enhance, t_enhance, sample_shape,
             features=('u_100m', 'v_100m'), **kwargs):
    train = make_fake_dset((20, 20, 60), list(features))
    val = make_fake_dset((20, 20, 30), list(features))
    return BatchHandler(
        [train], [val], batch_size=2, n_batches=2, s_enhance=s_enhance,
        t_enhance=t_enhance, sample_shape=sample_shape, **kwargs)


def _small_gen_s(n_feats=2):
    return generator_spatial(n_feats, (2,), filters=8, n_resblocks=1)


def _small_disc_st():
    return {'hidden_layers': [
        {'class': 'Conv3D', 'filters': 8, 'kernel_size': 3, 'strides': 2,
         'padding': 'same'},
        {'class': 'LeakyReLU', 'alpha': 0.2},
        {'class': 'Flatten'},
        {'class': 'Dense', 'units': 1}]}


def test_train_spatial(tmp_path):
    """History, meta, generate, and a save / load round trip."""
    handler = _handler(2, 1, (10, 10, 1))
    model = Sup3rGan(_small_gen_s(), get_config('spatial/disc_test'),
                     learning_rate=1e-4, device='cpu')
    out_dir = os.path.join(tmp_path, 'gan_{epoch}')
    model.train(handler, input_resolution=RES, n_epoch=2,
                weight_gen_advers=1e-2, out_dir=out_dir, checkpoint_int=1)
    assert len(model.history) == 2
    for col in ('train_loss_gen', 'val_loss_gen', 'train_loss_disc',
                'val_loss_disc', 'train_disc_train_frac', 'elapsed_time'):
        assert col in model.history
    assert model.history.index == [0, 1]
    assert model.meta['s_enhance'] == 2
    assert model.lr_features == ['u_100m', 'v_100m']
    assert model.hr_out_features == ['u_100m', 'v_100m']

    lr = np.random.default_rng(0).random((1, 8, 8, 2)).astype(np.float32)
    out = model.generate(lr)
    assert out.shape == (1, 16, 16, 2)
    loaded = Sup3rGan.load(os.path.join(tmp_path, 'gan_1'), device='cpu')
    np.testing.assert_allclose(loaded.generate(lr), out, rtol=1e-5,
                               atol=1e-6)
    assert len(loaded.history) == 2
    assert loaded._gen_opt_state['count'] == model._gen_opt_state['count']


def test_train_st_weights_move():
    handler = _handler(2, 2, (8, 8, 8), device_transform=True)
    model = Sup3rGan(generator_st(2, (2,), (2,), filters=8, n_resblocks=1),
                     _small_disc_st(), learning_rate=1e-4, device='cpu')
    model.init_weights((1, 4, 4, 4, 2), (1, 8, 8, 8, 2))
    before = [p.detach().clone() for p in model.gen_params]
    model.train(handler, input_resolution=RES, n_epoch=1,
                weight_gen_advers=1e-2, out_dir=None)
    assert model.meta['t_enhance'] == 2
    assert all(not torch.equal(a, b)
               for a, b in zip(before, model.gen_params))


def test_disc_gating():
    """Disc loss bounds at the extremes: the disc never / always trains."""
    for bounds, frac in (((np.inf, np.inf), 0.0), ((-np.inf, np.inf), 1.0)):
        model = Sup3rGan(_small_gen_s(), get_config('spatial/disc_test'),
                         device='cpu')
        model.init_weights((1, 5, 5, 2), (1, 10, 10, 2))
        before = [p.detach().clone() for p in model.disc_params]
        model.train(_handler(2, 1, (10, 10, 1)), input_resolution=RES,
                    n_epoch=1, disc_loss_bounds=bounds, out_dir=None)
        assert model.history['train_disc_train_frac'][-1] == frac
        moved = any(not torch.equal(a, b)
                    for a, b in zip(before, model.disc_params))
        assert moved == bool(frac)
        assert model._disc_opt_state['count'] == (2 if frac else 0)


def test_train_exo_features():
    features = ['u_100m', 'v_100m', 'topography']
    handler = _handler(2, 1, (10, 10, 1), features=features,
                       feature_sets={'hr_exo_features': ['topography']})
    gen = _small_gen_s()
    gen['hidden_layers'].insert(
        -3, {'class': 'Sup3rConcat', 'name': 'topography'})
    model = Sup3rGan(gen, get_config('spatial/disc_test'), device='cpu')
    model.train(handler, input_resolution=RES, n_epoch=1, out_dir=None)
    assert model.hr_exo_features == ['topography']
    assert model.hr_out_features == ['u_100m', 'v_100m']
    lr = np.random.default_rng(0).random((1, 5, 5, 3)).astype(np.float32)
    with pytest.raises(KeyError, match='topography'):
        model.generate(lr)
    topo = np.random.default_rng(1).random((1, 10, 10, 1)).astype(
        np.float32)
    assert model.generate(lr, exogenous_data={'topography': topo}).shape \
        == (1, 10, 10, 2)


def test_early_stopping():
    history = Record()
    for v in [1.0] * 8:
        history.append({'val_loss_gen': v})
    assert Sup3rGan.early_stop(history, 'val_loss_gen', threshold=0.01,
                               n_epoch=5)
    falling = Record()
    for v in np.linspace(2, 1, 8):
        falling.append({'val_loss_gen': float(v)})
    assert not Sup3rGan.early_stop(falling, 'val_loss_gen', threshold=0.01,
                                   n_epoch=5)
    model = Sup3rGan(_small_gen_s(), get_config('spatial/disc_test'),
                     optimizer={'name': 'SGD', 'learning_rate': 0.0},
                     device='cpu')
    model.train(_handler(2, 1, (10, 10, 1)), input_resolution=RES,
                n_epoch=6, early_stop_on='train_loss_gen',
                early_stop_threshold=1.0, early_stop_n_epoch=1,
                out_dir=None)
    assert len(model.history) == 2


def test_training_resume_extends_history(tmp_path):
    model = Sup3rGan(_small_gen_s(), get_config('spatial/disc_test'),
                     device='cpu')
    out_dir = os.path.join(tmp_path, 'gan_{epoch}')
    model.train(_handler(2, 1, (10, 10, 1)), input_resolution=RES,
                n_epoch=2, out_dir=out_dir)
    loaded = Sup3rGan.load(os.path.join(tmp_path, 'gan_1'), device='cpu')
    assert len(loaded.history) == 2
    loaded.train(_handler(2, 1, (10, 10, 1)), input_resolution=RES,
                 n_epoch=2, out_dir=out_dir)
    assert len(loaded.history) == 4
    assert loaded.history.index == [0, 1, 2, 3]
    assert os.path.exists(os.path.join(tmp_path, 'gan_3'))


def test_update_optimizer_preserves_state():
    model = Sup3rGan(_small_gen_s(), get_config('spatial/disc_test'),
                     learning_rate=1e-4, device='cpu')
    model.train(_handler(2, 1, (10, 10, 1)), input_resolution=RES,
                n_epoch=1, out_dir=None)
    state = model._gen_opt_state
    count = state['count']
    mu = [m.clone() for m in state['mu']]
    model.update_optimizer(option='all', learning_rate=5e-5)
    assert model._optimizer_config['learning_rate'] == 5e-5
    assert model._optimizer_disc_config['learning_rate'] == 5e-5
    assert model._gen_opt_state is state
    assert all(torch.equal(a, b) for a, b in zip(mu, state['mu']))
    model.train(_handler(2, 1, (10, 10, 1)), input_resolution=RES,
                n_epoch=1, out_dir=None)
    assert len(model.history) == 2
    assert model._gen_opt_state is state and state['count'] >= count


def test_not_ported_options_raise():
    model = Sup3rGan(_small_gen_s(), get_config('spatial/disc_test'),
                     device='cpu')
    model.init_weights((1, 5, 5, 2), (1, 10, 10, 2))
    lr, hr = np.zeros((1, 5, 5, 2)), np.zeros((1, 10, 10, 2))
    # train_shard_aligned and dp x sp meshes have come with item 9b
    # (tests/test_torch_halo_grad.py and tests/test_torch_parallel_2d.py
    # hold them); a spatial axis the mesh lacks is refused
    model.train_shard_aligned = True
    assert np.isfinite(list(model.run_gradient_descent(lr, hr).values())
                       ).all()
    del model.train_shard_aligned
    with pytest.raises(ValueError, match='second axis'):
        model.attach_mesh(get_mesh(devices='cpu'), spatial_axis='space')
    model.attach_mesh(get_mesh_2d(1, 1, devices='cpu'))
    assert model._mesh_spatial_axis == 'space'
    assert np.isfinite(list(model.run_gradient_descent(lr, hr).values())
                       ).all()
    model.attach_mesh(get_mesh(devices='cpu'))
    details = model.run_gradient_descent(lr, hr)
    assert np.isfinite(list(details.values())).all()
    # mode='lazy' is taken (laziness lives in the containers); an unknown
    # mode is refused
    assert _handler(2, 1, (10, 10, 1), mode='lazy').n_batches == 2
    with pytest.raises(ValueError, match='lazy'):
        _handler(2, 1, (10, 10, 1), mode='nope')
    model.train_remat = True
    with pytest.raises(NotImplementedError, match='train_remat'):
        model._maybe_remat(lambda x, exo: x)(
            torch.zeros(1), {}, train=True, dropout_generator=None)
    model.train_remat = False


# ----------------------------------------------------------------------
# save directories, both ways
def _reseed(seed):
    for rng in (RANDOM_GENERATOR, JAX_RNG):
        rng.bit_generator.state = np.random.default_rng(
            seed).bit_generator.state


def test_jax_save_resumes_in_the_port(tmp_path):
    """A JAX training run's save directory (weights, opt_state.msgpack,
    history.csv) loads in the port, which takes the same next step."""
    _reseed(3)
    train = jax_fake_dset((20, 20, 60), ['u_100m', 'v_100m'])
    handler = JaxBatchHandler([train], batch_size=2, n_batches=2,
                              s_enhance=2, sample_shape=(10, 10, 1))
    gen = _small_gen_s()
    disc = get_config('spatial/disc_test')
    jax_model = JaxGan(gen, disc, optimizer=STEP_OPT)
    jax_model.train(handler, input_resolution=RES, n_epoch=1,
                    out_dir=str(tmp_path / 'jax_{epoch}'))
    port = Sup3rGan.load(str(tmp_path / 'jax_0'), device='cpu')
    assert port._optimizer_config == jax_model._optimizer_config
    frame = pd.read_csv(tmp_path / 'jax_0' / 'history.csv', index_col=0)
    assert port.history.columns == list(frame.columns)
    for col in frame.columns:
        np.testing.assert_allclose(port.history[col], frame[col].values,
                                   rtol=1e-15)
    rng = np.random.default_rng(4)
    lr = rng.random((2, 5, 5, 2)).astype(np.float32)
    hr = rng.random((2, 10, 10, 2)).astype(np.float32)
    want = jax_model.run_gradient_descent(lr, hr, 1e-3, True, True)
    got = port.run_gradient_descent(lr, hr, 1e-3, True, True)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    _compare_networks(jax_model, port)


def test_port_save_resumes_in_jax(tmp_path):
    """A port training run's save directory loads in the JAX package:
    the same model params (optimizer included), history frame and next
    step."""
    model = Sup3rGan(_small_gen_s(), get_config('spatial/disc_test'),
                     optimizer=STEP_OPT,
                     optimizer_disc={'name': 'RMSprop',
                                     'learning_rate': 1e-4},
                     device='cpu')
    model.train(_handler(2, 1, (10, 10, 1)), input_resolution=RES,
                n_epoch=2, out_dir=str(tmp_path / 'gan_{epoch}'))
    saved = tmp_path / 'gan_1'
    jax_model = JaxGan.load(str(saved))
    assert jax_model._optimizer_disc_config == {
        'name': 'Rmsprop', 'learning_rate': 1e-4}
    frame = pd.read_csv(saved / 'history.csv', index_col=0)
    assert list(frame.index) == model.history.index
    assert list(frame.columns) == model.history.columns
    for col in frame.columns:
        # pandas' default float parser may land 1 ulp off repr's digits
        np.testing.assert_allclose(frame[col].values, model.history[col],
                                   rtol=1e-15)
    assert frame['train_gen'].dtype == np.int64
    rng = np.random.default_rng(5)
    lr = rng.random((2, 5, 5, 2)).astype(np.float32)
    hr = rng.random((2, 10, 10, 2)).astype(np.float32)
    want = jax_model.run_gradient_descent(lr, hr, 1e-3, True, False)
    got = model.run_gradient_descent(lr, hr, 1e-3, True, False)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    for got_p, want_p in zip(params_to_jax(model._gen),
                             _numpy_params(jax_model.gen_params)):
        for key in want_p:
            _close(got_p[key], want_p[key], key)
    nu = moments_to_jax(model._disc, model._disc_opt_state['nu'])
    for i, want_p in enumerate(jax_model._disc_opt_state[0].nu):
        for key in want_p:
            _close(nu[str(i)][key], want_p[key], f'disc nu {i} {key}')
