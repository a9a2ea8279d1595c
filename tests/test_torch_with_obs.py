"""The port's observation fusion (``Sup3rGanWithObs``, the
``Sup3rConcatObs`` / ``Sup3rObsModel`` / ``Dropout`` layers and
``ObsRasterizer``) against the JAX package's on the CPU.

The masks cannot share draws with ``jax.random`` (trap 2), so the steps
are held to the JAX package on a GIVEN mask: both models' mask samplers
are replaced by one that returns the same array. The port's sampler is
checked on its own: the observed fraction within the bounds, constant
over time unless ``time_frac`` < 1, and the same mask for the same step
on any device. Tolerance rtol 1e-4 of each value's largest magnitude
(the repository's fp32 parity bar); the steps run Adam with epsilon 1
(tests/test_torch_train_step.py says why).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sup3r_tpu.models.layers as jax_layers
from sup3r_tpu.configs import get_config
from sup3r_tpu.models import Sup3rGanWithObs as JaxObsGan
from sup3r_tpu.models.network import Network as JaxNetwork
from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
from sup3r_tpu.preprocessing.exo import ObsRasterizer as JaxObsRasterizer
from sup3r_tpu.utilities.test_helpers import (
    make_fake_flat_nc_file,
    make_fake_h5_file,
)
from sup3r_tpu.utilities.test_helpers import (
    make_fake_nc_file as jax_fake_nc,
)
from sup3r_tpu_torch.models import Network, Sup3rGanWithObs
from sup3r_tpu_torch.models.weights import params_from_jax, params_to_jax
from sup3r_tpu_torch.models.with_obs import _masked_mae
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import ExoDataHandler, ObsRasterizer
from sup3r_tpu_torch.utilities.test_helpers import make_fake_nc_file
from tests.forward_pass import test_obs_sza_fwp as obs_fwp
from tests.test_torch_train_step import _compare_networks

torch.set_num_threads(1)

RTOL = 1e-4
STEP_OPT = {'name': 'Adam', 'learning_rate': 1e-4, 'epsilon': 1.0}
FEATURES = ['u_100m', 'v_100m']
OBS_FRAC = {'spatial_frac': [0.2, 0.4]}
DISC_S = [{'class': 'Conv2D', 'filters': 4, 'kernel_size': 3,
           'strides': 2, 'padding': 'same'},
          {'class': 'LeakyReLU', 'alpha': 0.2},
          {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]


def _close(got, want, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = RTOL * float(np.nanmax(np.abs(want)))
    err = float(np.nanmax(np.abs(got - want)))
    assert err <= tol, (what, err, tol)


def _obs_raster(shape, seed, frac=0.3):
    """Random values, NaN away from a random ``frac`` of the cells."""
    rng = np.random.default_rng(seed)
    raster = rng.standard_normal(shape).astype(np.float32)
    raster[rng.random(shape) > frac] = np.nan
    return raster


def _spatial_gen(obs_layer='Sup3rConcatObs', **obs_kw):
    """test_model_family.py's WithObs generator."""
    return [{'class': 'Conv2D', 'filters': 16, 'kernel_size': 3,
             'strides': 1, 'padding': 'same'},
            {'class': 'SpatialExpansion', 'spatial_mult': 2},
            {'class': 'LeakyReLU', 'alpha': 0.2},
            {'class': obs_layer, 'name': 'u_100m_obs', **obs_kw},
            {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3,
             'strides': 1, 'padding': 'same'}]


def flagship_obs_gen(cfg):
    """The flagship with ``Sup3rConcatObs`` for u and v inserted after
    its last LeakyReLU, before its tail conv (test_model_family.py's
    placement; the tail becomes 12 -> 2)."""
    layers = list(cfg['hidden_layers'])
    last = max(i for i, lyr in enumerate(layers)
               if lyr.get('class') == 'LeakyReLU')
    obs = [{'class': 'Sup3rConcatObs', 'name': f'{f}_obs'}
           for f in FEATURES]
    return {'hidden_layers': layers[:last + 1] + obs + layers[last + 1:]}


# ----------------------------------------------------------------------
# layers
@pytest.mark.parametrize('layer', [
    {'class': 'Sup3rConcatObs', 'name': 'u_100m_obs'},
    {'class': 'Sup3rObsModel', 'name': 'u_100m_obs'},
    {'class': 'Sup3rObsModel', 'name': 'u_100m_obs', 'filters': 5}])
@pytest.mark.parametrize('in_shape', [(2, 6, 5, 3), (2, 4, 4, 3, 3)])
def test_obs_layers_match_jax(layer, in_shape):
    """On the same params and a NaN-sparse raster, and finite gradients
    (trap 3: NaN becomes 0 before the conv)."""
    jax_net = JaxNetwork([dict(layer)])
    params, out_shape = jax_net.init(jax.random.PRNGKey(0), in_shape)
    assert Network([dict(layer)]).out_shape(in_shape) == out_shape
    net = Network([dict(layer)])
    net.init(in_shape, torch.Generator().manual_seed(0))
    params_from_jax(net, [{k: np.asarray(v) for k, v in p.items()}
                          for p in params])
    for got, want in zip(params_to_jax(net), params):
        assert sorted(got) == sorted(want)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(in_shape).astype(np.float32)
    obs = _obs_raster(in_shape[:-1] + (1,), 2)
    want = jax_net.apply(params, jnp.asarray(x),
                         exo={'u_100m_obs': jnp.asarray(obs)})
    xt = torch.tensor(x, requires_grad=True)
    for p in net.parameters():
        p.requires_grad_(True)
    got = net.apply(xt, {'u_100m_obs': torch.tensor(obs)})
    _close(got.detach().numpy(), want)
    grads = torch.autograd.grad(got.square().sum(),
                                [xt, *net.parameters()])
    assert all(torch.isfinite(g).all() for g in grads)
    assert net.obs_features == ['u_100m_obs'] and not net.exo_features


@pytest.mark.parametrize('rate', [0.3, 0.0])
def test_dropout_matches_jax_on_a_given_mask(monkeypatch, rate):
    """Inverted dropout: the port's mask comes from the generator it is
    given; the JAX layer on the same mask gives the same output. Off
    without ``train`` or a generator."""
    x = np.random.default_rng(3).standard_normal((2, 4, 4, 6)).astype(
        np.float32)
    net = Network([{'class': 'Dropout', 'rate': rate}])
    assert net.has_dropout
    got = net.apply(torch.tensor(x), train=True,
                    dropout_generator=torch.Generator().manual_seed(5))
    keep = torch.rand((2, 6, 4, 4), generator=torch.Generator().manual_seed(
        5)) < 1 - rate
    mask = keep.permute(0, 2, 3, 1).numpy()
    monkeypatch.setattr(jax_layers.jax.random, 'bernoulli',
                        lambda key, p, shape: jnp.asarray(mask))
    want = JaxNetwork([{'class': 'Dropout', 'rate': rate}]).apply(
        [{}], jnp.asarray(x), train=True, dropout_key=jax.random.PRNGKey(0))
    _close(got.numpy(), want)
    for kw in ({}, {'train': True},
               {'dropout_generator': torch.Generator()}):
        np.testing.assert_array_equal(net.apply(torch.tensor(x),
                                                **kw).numpy(), x)


def test_masked_mae_without_observations_is_zero():
    """Trap 3: an all-unobserved batch gives 0, not NaN."""
    a, b = torch.ones(2, 3), torch.zeros(2, 3)
    assert float(_masked_mae(a, b, torch.zeros(2, 3))) == 0.0
    assert float(_masked_mae(a, b, torch.ones(2, 3))) == 1.0


# ----------------------------------------------------------------------
# the mask sampler
def test_obs_mask_statistics():
    model = Sup3rGanWithObs(_spatial_gen(), DISC_S, device='cpu',
                            onshore_obs_frac=OBS_FRAC)
    fracs = []
    for seed in range(20):
        not_obs = model._sample_obs_mask(
            (2, 30, 30, 12, 2), torch.Generator().manual_seed(seed))
        obs = ~not_obs
        assert (obs == obs[..., :1, :1]).all()  # constant over time
        assert (obs == obs[:1]).all()           # and batch, channels
        fracs.append(float(obs.float().mean()))
    assert 0.15 < min(fracs) and max(fracs) < 0.45
    assert np.std(fracs) > 0
    model.onshore_obs_frac = {'spatial_frac': 0.5, 'time_frac': 0.5}
    obs = ~model._sample_obs_mask((1, 20, 20, 40, 1),
                                  torch.Generator().manual_seed(0))
    per_t = obs.float().mean(dim=(0, 1, 2, 4))
    assert (per_t == 0).any() and (per_t > 0.3).any()
    again = ~model._sample_obs_mask((1, 20, 20, 40, 1),
                                    torch.Generator().manual_seed(0))
    assert torch.equal(obs, again)


# ----------------------------------------------------------------------
# train / validation steps on a given mask
CASES = {
    'spatial': (_spatial_gen(), DISC_S, (2, 5, 5, 2), (2, 10, 10, 2)),
    'spatial_obs_model': (_spatial_gen('Sup3rObsModel', filters=4),
                          DISC_S, (2, 5, 5, 2), (2, 10, 10, 2)),
    'flagship': (flagship_obs_gen(get_config(
        'spatiotemporal/gen_3x_4x_2f')),
        get_config('spatiotemporal/disc_test'), (1, 4, 4, 2, 2),
        (1, 12, 12, 8, 2)),
}
_PAIRS = {}


def _pair(name, **kw):
    """(JAX model, port model) with the port's seeded weights in both,
    their mask samplers returning the same given mask."""
    gen, disc, lr_shape, hr_shape = CASES[name]
    kw = {'onshore_obs_frac': OBS_FRAC, 'loss_obs_weight': 0.5,
          'optimizer': STEP_OPT,
          'meta': {'hr_out_features': FEATURES, 'lr_features': FEATURES},
          **kw}
    one = ((1,) + lr_shape[1:], (1,) + hr_shape[1:])
    port = Sup3rGanWithObs(gen, disc, device='cpu', **kw)
    port.init_weights(*one, seed=0)
    jax_model = JaxObsGan(gen, disc, **kw)
    jax_model.init_weights(*one)
    jax_model.gen_params = jax.tree.map(jnp.asarray, params_to_jax(port._gen))
    jax_model.disc_params = jax.tree.map(jnp.asarray,
                                         params_to_jax(port._disc))
    jax_model._gen_opt_state = jax_model._gen_tx.init(jax_model.gen_params)
    jax_model._disc_opt_state = jax_model._disc_tx.init(
        jax_model.disc_params)
    rng = np.random.default_rng(4)
    not_obs = rng.random(hr_shape[1:3]) > 0.3
    not_obs = np.broadcast_to(not_obs[None, ..., *([None] * (
        len(hr_shape) - 3))], hr_shape).copy()
    port._sample_obs_mask = lambda shape, generator: torch.as_tensor(
        not_obs)
    jax_model._sample_obs_mask = lambda key, shape: jnp.asarray(not_obs)
    return jax_model, port, not_obs


#: steps per case: the flagship's second step on this tiny batch puts one
#: pre-activation of its block 30 within 1.3e-7 of zero, which fp32
#: rounding puts on either side of its LeakyReLU (the port's float64 step
#: agrees with the JAX package's there), so it is held to one step
N_STEPS = {'spatial': 2, 'spatial_obs_model': 2, 'flagship': 1}


@pytest.mark.parametrize('name', list(CASES))
def test_train_step_matches_jax_on_a_given_mask(name):
    jax_model, port, not_obs = _pair(name)
    _, _, lr_shape, hr_shape = CASES[name]
    rng = np.random.default_rng(0)
    lr = rng.random(lr_shape).astype(np.float32)
    hr = rng.random(hr_shape).astype(np.float32)
    for _ in range(N_STEPS[name]):
        want = jax_model.run_gradient_descent(lr, hr, 1e-3, True, True)
        got = port.run_gradient_descent(lr, hr, 1e-3, True, True)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=key)
    assert got['obs_frac'] == pytest.approx(1 - not_obs.mean())
    _compare_networks(jax_model, port)


def test_step_without_observed_cells_is_finite():
    """Trap 3 in the step: no observed cell gives loss_obs 0, finite
    losses and finite updates."""
    _, port, _ = _pair('spatial')
    port._sample_obs_mask = lambda shape, generator: torch.ones(
        shape, dtype=torch.bool)
    rng = np.random.default_rng(1)
    out = port.run_gradient_descent(
        rng.random((2, 5, 5, 2)), rng.random((2, 10, 10, 2)), 1e-3, True,
        True)
    assert out['loss_obs'] == 0.0 and out['obs_frac'] == 0.0
    assert all(np.isfinite(v) for v in out.values())
    assert all(torch.isfinite(p).all() for p in port.gen_params)


def test_val_step_matches_jax_on_a_given_mask():
    jax_model, port, _ = _pair('spatial')
    rng = np.random.default_rng(2)
    lr = rng.random((2, 5, 5, 2)).astype(np.float32)
    hr = rng.random((2, 10, 10, 2)).astype(np.float32)
    want = jax_model._get_val_step_fn()(
        jax_model.gen_params, jax_model.disc_params, jnp.asarray(lr),
        jnp.asarray(hr), jnp.float32(1e-3), jax.random.PRNGKey(0))
    with torch.no_grad():
        got = port._val_step(torch.tensor(lr), torch.tensor(hr), 1e-3)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=RTOL, err_msg=key)


def test_generate_normalizes_obs_with_base_stats():
    """Trap 4: an ``*_obs`` raster takes its base feature's mean and
    std at inference, in both packages."""
    jax_model, port, _ = _pair('spatial')
    means, stds = {'u_100m': 0.5, 'v_100m': -1.0}, {'u_100m': 2.0,
                                                     'v_100m': 3.0}
    port.set_norm_stats(means, stds)
    jax_model.set_norm_stats(means, stds)
    lr = np.random.default_rng(5).random((2, 5, 5, 2)).astype(np.float32)
    obs = _obs_raster((2, 10, 10, 1), 6)
    _close(port.generate(lr, exogenous_data={'u_100m_obs': obs}),
           jax_model.generate(lr, exogenous_data={'u_100m_obs': obs}))
    with pytest.raises(KeyError, match='u_100m_obs'):
        port.generate(lr)


# ----------------------------------------------------------------------
# save / load / resume across packages
def test_save_load_resume_across_packages(tmp_path):
    jax_model, port, _ = _pair('spatial_obs_model', loss_obs='MAE_obs')
    rng = np.random.default_rng(3)
    lr, hr = rng.random((2, 5, 5, 2)), rng.random((2, 10, 10, 2))
    port.run_gradient_descent(lr, hr, 1e-3, True, True)
    jax_model.run_gradient_descent(lr, hr, 1e-3, True, True)
    port.save(str(tmp_path / 'port'))
    jax_model.save(str(tmp_path / 'jax'))
    from_jax = Sup3rGanWithObs.load(str(tmp_path / 'jax'), device='cpu')
    to_jax = JaxObsGan.load(str(tmp_path / 'port'))
    for model in (from_jax, to_jax):
        assert model.onshore_obs_frac == OBS_FRAC
        assert model.loss_obs_weight == 0.5
        assert model.loss_obs_name == 'MAE_obs'
        assert model.obs_features == ['u_100m_obs']
    assert from_jax._gen_opt_state['count'] == 1
    _compare_networks(to_jax, port)
    _compare_networks(jax_model, from_jax)


# ----------------------------------------------------------------------
# ObsRasterizer
def _stations(tmp_path, kind):
    """A few stations inside an (8, 8) LR domain, as an H5 site list, a
    flattened NetCDF or a gridded NetCDF3 that is NaN off the
    stations."""
    lat, lon = (39.9, 39.7), (-105.3, -105.1)
    if kind == 'h5':
        return make_fake_h5_file(str(tmp_path / 'obs.h5'), (3, 3, 4),
                                 ['u_100m'], lat_range=lat, lon_range=lon)
    if kind == 'flat_nc':
        return make_fake_flat_nc_file(str(tmp_path / 'obs_flat.nc'),
                                      (3, 3, 4), ['u_100m'], lat_range=lat,
                                      lon_range=lon)
    data = {'u_100m': _obs_raster((4, 12, 12), 7, frac=0.1)}
    return make_fake_nc_file(str(tmp_path / 'obs_grid.nc'), (12, 12, 4),
                             ['u_100m'], lat_range=(40.0, 39.0),
                             lon_range=(-105.5, -104.3), data=data)


@pytest.mark.parametrize('kind', ['h5', 'flat_nc', 'grid_nc'])
@pytest.mark.parametrize('s_enhance,t_enhance', [(1, 1), (2, 2)])
def test_obs_rasterizer_matches_jax(tmp_path, kind, s_enhance, t_enhance):
    """Rasters (NaN where no station maps) and cache names bit for bit
    as the JAX package's."""
    lr_fp = jax_fake_nc(str(tmp_path / 'lr.nc'), (8, 8, 4), ['u100'])
    src = _stations(tmp_path, kind)
    kw = dict(file_paths=lr_fp, source_file=src, feature='u_100m_obs',
              s_enhance=s_enhance, t_enhance=t_enhance)
    got = ObsRasterizer(cache_dir=str(tmp_path / 'port'), **kw)
    want = JaxObsRasterizer(cache_dir=str(tmp_path / 'jax'), **kw)
    assert (os.path.basename(got.cache_file)
            == os.path.basename(want.cache_file))
    g, w = got.data, want.data
    assert g.shape == w.shape == (8 * s_enhance, 8 * s_enhance,
                                  4 * t_enhance, 1)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    assert np.isnan(g).any() and np.isfinite(g).any()
    np.testing.assert_allclose(g, w, rtol=1e-6)
    np.testing.assert_array_equal(np.load(got.cache_file), g)


def test_exo_handler_gives_obs_rasters(tmp_path):
    """``*_obs`` features go to ``ObsRasterizer`` (layer steps, base
    feature read from the source, NaN kept)."""
    lr_fp = jax_fake_nc(str(tmp_path / 'lr.nc'), (8, 8, 4), ['u100'])
    model = Sup3rGanWithObs(_spatial_gen(), DISC_S, device='cpu',
                            meta={'lr_features': FEATURES,
                                  'hr_out_features': FEATURES,
                                  's_enhance': 2, 't_enhance': 1})
    handler = ExoDataHandler(lr_fp, 'u_100m_obs', model=model,
                             source_file=_stations(tmp_path, 'grid_nc'),
                             cache_dir=str(tmp_path / 'c'))
    steps = handler.data['u_100m_obs']['steps']
    assert [(s['combine_type'], s['s_enhance']) for s in steps] == [
        ('layer', 2)]
    assert steps[0]['data'].shape == (16, 16, 4, 1)
    assert np.isnan(steps[0]['data']).any()
    assert handler._rasterizer_class('u_100m_obs') is ObsRasterizer


def test_sparse_obs_forward_pass_matches_jax(tmp_path):
    """test_obs_sza_fwp.py::test_fwp_with_sparse_obs_exo through both
    packages, on the JAX package's saved model."""
    input_file = jax_fake_nc(str(tmp_path / 'input.nc'), (10, 10, 3),
                             ['u100', 'v100'])
    obs_file = make_fake_h5_file(
        str(tmp_path / 'obs.h5'), (3, 3, 3), ['u_100m'],
        lat_range=(39.9, 39.2), lon_range=(-105.3, -104.5))
    model_dir = obs_fwp._obs_gan(tmp_path)
    outs = []
    for name, Strategy, Pass, mkw in (
            ('port', ForwardPassStrategy, ForwardPass,
             {'model_dir': model_dir, 'device': 'cpu'}),
            ('jax', JaxStrategy, JaxForwardPass, {'model_dir': model_dir})):
        strategy = Strategy(
            file_paths=input_file, model_kwargs=mkw,
            model_class='Sup3rGanWithObs', fwp_chunk_shape=(5, 5, 3),
            spatial_pad=1, temporal_pad=0,
            exo_handler_kwargs={'u_100m_obs': {
                'source_file': obs_file,
                'cache_dir': str(tmp_path / f'exo_{name}')}},
            out_pattern=None)
        outs.append(Pass.run(strategy, 0))
    assert sorted(outs[0]) == sorted(outs[1]) and len(outs[0]) == 4
    for idx in outs[1]:
        assert np.isfinite(outs[0][idx]).all()
        _close(outs[0][idx], outs[1][idx], idx)


def test_dropout_in_the_train_step():
    """A network with ``Dropout`` draws its masks in the train step only,
    from generators seeded with the step counter: two copies at the same
    step take the same step; serving skips the layer."""
    gen = _spatial_gen()
    gen.insert(3, {'class': 'Dropout', 'rate': 0.5})
    disc = DISC_S[:2] + [{'class': 'Dropout', 'rate': 0.25}] + DISC_S[2:]
    models = []
    for _ in range(2):
        model = Sup3rGanWithObs(gen, disc, device='cpu',
                                onshore_obs_frac=OBS_FRAC,
                                meta={'hr_out_features': FEATURES,
                                      'lr_features': FEATURES})
        model.init_weights((1, 5, 5, 2), (1, 10, 10, 2), seed=0)
        models.append(model)
    rng = np.random.default_rng(8)
    lr, hr = rng.random((2, 5, 5, 2)), rng.random((2, 10, 10, 2))
    got = [m.run_gradient_descent(lr, hr, 1e-3, True, True) for m in models]
    assert got[0] == got[1]
    for a, b in zip(models[0].gen_params, models[1].gen_params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    plain = Sup3rGanWithObs(_spatial_gen(), DISC_S, device='cpu')
    plain.init_weights((1, 5, 5, 2), (1, 10, 10, 2), seed=0)
    params = params_to_jax(models[0]._gen)
    del params[3]  # the Dropout layer's (empty) entry
    params_from_jax(plain._gen, params)
    obs = {'u_100m_obs': _obs_raster((2, 10, 10, 1), 9)}
    lr32 = lr.astype(np.float32)
    np.testing.assert_array_equal(
        models[0].generate(lr32, norm_in=False, un_norm_out=False,
                           exogenous_data=obs),
        plain.generate(lr32, norm_in=False, un_norm_out=False,
                       exogenous_data=obs))
