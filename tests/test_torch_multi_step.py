"""The port's model chains against the JAX package's on the same inputs
and weights: ``MultiStepGan.generate`` of a spatial-with-topography step
then a temporal step (the Sup3rCC wind chain's ``generator_cc_spatial``
/ ``generator_cc_temporal`` at 8 filters and 1 residual block, and small
hand-written steps), ``LinearInterp``, the 4D <-> 5D transposes, a
feature subset between steps and a missing feature raising. Weights
cross in both directions: a chain the JAX package saved loads in the
port, one the port saved loads in the JAX package, and
``chain_params_from_jax`` carries them member by member. Tolerance rtol
1e-4 of the output's largest magnitude, the repository's fp32 parity
bar."""

import os

import jax
import numpy as np
import pytest
import torch

from sup3r_tpu.configs import generator_cc_spatial, generator_cc_temporal
from sup3r_tpu.models import LinearInterp as JaxLinear
from sup3r_tpu.models import MultiStepGan as JaxChain
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu_torch.models import (
    LinearInterp,
    MultiStepGan,
    Sup3rGan,
    chain_params_from_jax,
)
from tests.models import test_multi_step_units as units

torch.set_num_threads(1)

RTOL = 1e-4
WIND = ['u_10m', 'v_10m', 'u_100m', 'v_100m', 'temperature_2m',
        'relativehumidity_2m']
T_LR = 3
DISC = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = RTOL * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol, (err, tol)


def _stats(features, rng):
    return ({f: float(rng.normal()) for f in features},
            {f: float(0.5 + rng.random()) for f in features})


def _cc_chain(tmp_path):
    """The Sup3rCC wind chain at 8 filters and 1 residual block, saved by
    the JAX package: (step directories, JAX chain)."""
    rng = np.random.default_rng(0)
    means, stds = _stats([*WIND, 'topography'], rng)
    spatial = JaxGan(generator_cc_spatial(6, 5, filters=8, n_resblocks=1),
                     DISC,
                     meta={'lr_features': [*WIND, 'topography'],
                           'hr_out_features': list(WIND),
                           's_enhance': 5, 't_enhance': 1},
                     means=means, stdevs=stds)
    spatial.init_weights((1, 4, 4, 7), (1, 20, 20, 6))
    means, stds = _stats(WIND, rng)
    temporal = JaxGan(
        generator_cc_temporal(6, 24, 12, filters=8, n_resblocks=1),
        DISC,
        meta={'lr_features': list(WIND), 'hr_out_features': list(WIND),
              's_enhance': 1, 't_enhance': 24},
        means=means, stdevs=stds)
    temporal.init_weights((1, 4, 4, T_LR, 6), (1, 4, 4, 24 * T_LR, 6))
    chain = JaxChain([spatial, temporal])
    chain.save(str(tmp_path / 'cc'))
    return ([str(tmp_path / 'cc' / f'model_step_{i}') for i in (0, 1)],
            chain)


def _cc_inputs():
    rng = np.random.default_rng(1)
    lr = rng.standard_normal((T_LR, 4, 4, 6)).astype(np.float32)
    topo_lr = (rng.random((T_LR, 4, 4, 1)) * 1000).astype(np.float32)
    topo_hr = (rng.random((T_LR, 20, 20, 1)) * 1000).astype(np.float32)
    exo = {'topography': {'steps': [
        {'model': 0, 'combine_type': 'input', 'data': topo_lr},
        {'model': 0, 'combine_type': 'layer', 'data': topo_hr}]}}
    return lr, exo


@pytest.fixture(scope='module')
def cc(tmp_path_factory):
    dirs, jchain = _cc_chain(tmp_path_factory.mktemp('cc'))
    lr, exo = _cc_inputs()
    want = np.asarray(jchain.generate(lr, exogenous_data=exo))
    return dirs, jchain, want


def test_cc_wind_chain_matches_jax(cc):
    """A chain the JAX package saved, loaded by the port (one
    model_kwargs dict for both steps), with structured topography exo
    for step 0: input channel and Sup3rConcat layer."""
    dirs, _, want = cc
    chain = MultiStepGan.load(dirs, model_kwargs={'verbose': False},
                              device='cpu')
    assert [type(m).__name__ for m in chain.models] == ['Sup3rGan'] * 2
    assert chain.is_4d and chain.s_enhance == 5 and chain.t_enhance == 24
    assert chain.lr_features == [*WIND, 'topography']
    assert chain.hr_out_features == WIND
    lr, exo = _cc_inputs()
    got = chain.generate(lr, exogenous_data=exo)
    assert isinstance(got, np.ndarray)
    assert got.shape == (1, 20, 20, 24 * T_LR, 6)
    _close(got, want)


def test_port_saved_chain_loads_in_jax(cc, tmp_path):
    dirs, _, want = cc
    MultiStepGan.load(dirs, device='cpu').save(str(tmp_path))
    back = JaxChain.load([str(tmp_path / f'model_step_{i}')
                          for i in (0, 1)])
    lr, exo = _cc_inputs()
    _close(np.asarray(back.generate(lr, exogenous_data=exo)), want)


def test_chain_params_from_jax(cc):
    """Fresh port members take the JAX chain's weights member by
    member."""
    dirs, jchain, want = cc
    chain = MultiStepGan.load(dirs, device='cpu')
    for member in chain.models:
        for p in member.generator.parameters():
            torch.nn.init.zeros_(p)
    chain_params_from_jax(chain, [jax.tree.map(np.asarray, m.gen_params)
                                  for m in jchain.models])
    lr, exo = _cc_inputs()
    _close(chain.generate(lr, exogenous_data=exo), want)
    with pytest.raises(ValueError, match='members'):
        chain_params_from_jax(chain, [None])


def test_chain_inference_mode(cc):
    dirs, _, _ = cc
    chain = MultiStepGan.load(dirs, device='cpu')
    assert chain.inference_mode == 'exact'
    chain.inference_mode = 'fast'
    assert [m.inference_mode for m in chain.models] == ['fast', 'fast']
    chain.models[0].inference_mode = 'exact'
    assert chain.inference_mode == 'custom'
    lin = MultiStepGan([LinearInterp(WIND, 2, 1, device='cpu')])
    assert lin.inference_mode == 'exact'
    with pytest.raises(ValueError, match='supports'):
        lin.inference_mode = 'fast'


@pytest.mark.parametrize('t_centered', [False, True])
def test_linear_interp_matches_jax(tmp_path, t_centered):
    rng = np.random.default_rng(2)
    lr = rng.standard_normal((2, 5, 6, 4, 2)).astype(np.float32)
    jmodel = JaxLinear(['u_100m', 'V_100m'], 3, 4, t_centered=t_centered)
    jmodel.save(str(tmp_path))
    model = LinearInterp.load(str(tmp_path), device='cpu')
    assert model.meta == jmodel.meta
    got = model.generate(lr)
    assert got.dtype == np.float32
    _close(got, np.asarray(jmodel.generate(lr)))
    model.save(str(tmp_path / 'port'))
    assert JaxLinear.load(str(tmp_path / 'port')).meta == jmodel.meta


def _port(jmodel, tmp_path, name):
    jmodel.save(str(tmp_path / name))
    return Sup3rGan.load(str(tmp_path / name), device='cpu')


def test_linear_then_gan_chain_matches_jax(tmp_path):
    """A LinearInterp step feeding a GAN step (the host intermediate)."""
    jgan = units._temporal(2)
    jchain = JaxChain([JaxLinear(units.FEATURES, 2, 1), jgan])
    chain = MultiStepGan([LinearInterp(units.FEATURES, 2, 1, device='cpu'),
                          _port(jgan, tmp_path, 't')])
    lr = np.random.default_rng(3).random((1, 4, 4, 3, 2)).astype(np.float32)
    got = chain.generate(lr)
    assert got.shape == (1, 8, 8, 6, 2)
    _close(got, np.asarray(jchain.generate(lr)))


def test_4d_to_5d_transpose_matches_jax(tmp_path):
    j1, j2 = units._spatial(2), units._temporal(2)
    chain = MultiStepGan([_port(j1, tmp_path, 's'),
                          _port(j2, tmp_path, 't')])
    lr = np.random.default_rng(1).random((2, 4, 4, 2)).astype(np.float32)
    got = chain.generate(lr)
    assert got.shape == (1, 8, 8, 4, 2)
    _close(got, np.asarray(JaxChain([j1, j2]).generate(lr)))
    # and back: a 5D step feeding a 4D step
    x = np.random.default_rng(2).random((1, 4, 4, 3, 2)).astype(np.float32)
    j3 = units._temporal(2)
    j3.init_weights((1, 4, 4, 3, 2), (1, 4, 4, 6, 2))
    chain = MultiStepGan([_port(j3, tmp_path, 't3'),
                          _port(j1, tmp_path, 's1')])
    got = chain.generate(x)
    assert got.shape == (6, 8, 8, 2)
    _close(got, np.asarray(JaxChain([j3, j1]).generate(x)))


def test_feature_subset_between_steps_matches_jax(tmp_path):
    j1 = units._spatial(2, out_feats=['u_100m', 'v_100m', 'topography'])
    j2 = units._spatial(2)
    chain = MultiStepGan([_port(j1, tmp_path, 'a'),
                          _port(j2, tmp_path, 'b')])
    lr = np.random.default_rng(2).random((1, 4, 4, 2)).astype(np.float32)
    _close(chain.generate(lr), np.asarray(JaxChain([j1, j2]).generate(lr)))


def test_missing_feature_between_steps_raises(tmp_path):
    chain = MultiStepGan([
        _port(units._spatial(2, out_feats=['u_100m']), tmp_path, 'a'),
        _port(units._spatial(2), tmp_path, 'b')])
    lr = np.random.default_rng(3).random((1, 4, 4, 2)).astype(np.float32)
    with pytest.raises(ValueError, match='not all in'):
        chain.generate(lr)


def test_enhancements_and_later_chains(tmp_path):
    chain = MultiStepGan([
        _port(units._spatial(2), tmp_path, 'a'),
        _port(units._spatial(3), tmp_path, 'b'),
        LinearInterp(units.FEATURES, 1, 4, device='cpu')])
    assert chain.s_enhancements == [2, 3, 1]
    assert chain.t_enhancements == [1, 1, 4]
    assert chain.s_enhance == 6 and chain.t_enhance == 4
    assert chain.device.type == 'cpu' and len(chain) == 3
    from sup3r_tpu_torch import models

    assert models.Sup3rCondMom.__name__ == 'Sup3rCondMom'
    assert models.SolarMultiStepGan.__name__ == 'SolarMultiStepGan'
    assert models.MultiStepSurfaceMetGan.__name__ == (
        'MultiStepSurfaceMetGan')


def test_chain_load_defaults_to_the_card(cc, tmp_path, monkeypatch):
    """``MultiStepGan.load``, ``LinearInterp`` and a chain strategy with
    exo load onto the card unless the caller asks for the CPU, and raise
    without one."""
    from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
    from sup3r_tpu_torch.pipeline import ForwardPassStrategy

    dirs, _, _ = cc
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiStepGan.load(dirs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LinearInterp(WIND, 2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ForwardPassStrategy(
            file_paths=make_fake_nc_file(str(tmp_path / 'in.nc'),
                                         (4, 4, 3), WIND),
            model_class='MultiStepGan', model_kwargs={'model_dirs': dirs},
            exo_handler_kwargs={'topography': {'source_file': 'x.nc'}},
            fwp_chunk_shape=(4, 4, 3), out_pattern=None)
    assert os.path.isdir(dirs[0])


def test_chain_memory_estimate_matches_jax(cc):
    """``device_batch_size='auto'`` sizes a chain by its hungriest member
    at each member's enhanced input shape, and a linear step by its input
    and output, as the JAX package's planner does."""
    from sup3r_tpu.pipeline import memory as jmemory
    from sup3r_tpu_torch.pipeline import memory

    dirs, jchain, _ = cc
    chain = MultiStepGan.load(dirs, device='cpu')
    for shape in ((14, 14, 6, 7), (10, 10, 4, 7)):
        got = memory.estimate_activation_bytes(chain, shape)
        assert got == jmemory.estimate_activation_bytes(jchain, shape)
        assert got > max(memory.estimate_activation_bytes(m, shape)
                         for m in chain.models[:1])
    lin = MultiStepGan([LinearInterp(WIND, 2, 3, device='cpu')])
    jlin = JaxChain([JaxLinear(WIND, 2, 3)])
    assert memory.estimate_activation_bytes(lin, (4, 4, 2, 6)) == \
        jmemory.estimate_activation_bytes(jlin, (4, 4, 2, 6))
    assert memory.resolve_device_batch_size(
        chain, (14, 14, 6), 7, hbm_bytes=2 ** 30) == \
        jmemory.resolve_device_batch_size(jchain, (14, 14, 6), 7,
                                          hbm_bytes=2 ** 30)
