"""The serving slice as a whole: the port's ``Sup3rGan.generate`` against
the JAX package's on a flagship-shaped but narrow generator
(``generator_st(2, (3,), (2, 2), filters=8, n_resblocks=2)``) with norm
stats, its weights carried across by ``params_from_jax`` or read from a
directory the JAX ``Sup3rGan.save`` wrote. Tolerance rtol 1e-4 / atol
1e-5, the repository's fp32 parity bar."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sup3r_tpu.configs import generator_st, get_config
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu_torch.models import Sup3rGan, params_from_jax
from sup3r_tpu_torch.ops import kernels

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LR_SHAPE = (2, 6, 6, 4, 2)
HR_SHAPE = (2, 18, 18, 16, 2)
FEATURES = ['u_100m', 'v_100m']


def _kwargs():
    return dict(meta={'lr_features': list(FEATURES),
                      'hr_out_features': list(FEATURES)},
                means={'u_100m': 0.5, 'v_100m': -0.2},
                stdevs={'u_100m': 0.3, 'v_100m': 0.7})


def _configs():
    return (generator_st(2, (3,), (2, 2), filters=8, n_resblocks=2),
            get_config('spatiotemporal/disc_test'))


@pytest.fixture(scope='module')
def models():
    """(JAX model, port model with the JAX weights) on the CPU."""
    gen, disc = _configs()
    jmodel = JaxGan(gen, disc, **_kwargs())
    jmodel.init_weights(LR_SHAPE, HR_SHAPE)
    model = Sup3rGan(gen, disc, device='cpu', **_kwargs())
    model.init_weights(LR_SHAPE, HR_SHAPE)
    params_from_jax(model.generator,
                    jax.tree.map(np.asarray, jmodel.gen_params))
    return jmodel, model


@pytest.fixture(scope='module')
def low_res():
    rng = np.random.default_rng(0)
    return (rng.standard_normal(LR_SHAPE) * 0.5 + 0.3).astype(np.float32)


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package's Pallas path on the CPU: ``FusedReflectConv``
    sees a TPU backend and every ``pl.pallas_call`` runs in interpret
    mode. Returns the names of the kernel bodies traced."""
    orig = pl.pallas_call
    calls = []

    def interp(kernel, *a, **kw):
        kw['interpret'] = True
        kw.pop('compiler_params', None)
        calls.append(getattr(kernel, 'func', kernel).__name__)
        return orig(kernel, *a, **kw)

    monkeypatch.setattr(pl, 'pallas_call', interp)
    monkeypatch.setattr(jax, 'default_backend', lambda: 'tpu')
    return calls


def _generate_both(models, low_res, fuse, pallas=False):
    jmodel, model = models
    jmodel.inference_fuse = model.inference_fuse = fuse
    jmodel.inference_pallas = model.inference_pallas = pallas
    try:
        return model.generate(low_res), jmodel.generate(low_res)
    finally:
        jmodel.inference_fuse = model.inference_fuse = True
        jmodel.inference_pallas = model.inference_pallas = False


@pytest.mark.parametrize('fuse', [True, False], ids=['fused', 'unfused'])
def test_generate_matches_jax(models, low_res, fuse):
    got, want = _generate_both(models, low_res, fuse)
    assert got.shape == want.shape == HR_SHAPE
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_generate_inference_pallas_matches_jax_pallas(models, low_res,
                                                      jax_pallas):
    got, want = _generate_both(models, low_res, True, pallas=True)
    # the JAX side ran both Pallas kernels
    assert {'_small_conv_kernel', '_reflect_conv_kernel_3d'} <= set(
        jax_pallas)
    assert got.shape == want.shape == HR_SHAPE
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # on the CPU the port's wrappers take their plain versions
    assert kernels.small_reflect_conv_cf.launches == 0
    assert kernels.reflect_conv_cf.launches == 0


def test_fused_equals_unfused(models, low_res):
    _, model = models
    fused = model.generate(low_res)
    model.inference_fuse = False
    try:
        unfused = model.generate(low_res)
    finally:
        model.inference_fuse = True
    np.testing.assert_allclose(fused, unfused, rtol=1e-5, atol=1e-6)


def test_load_jax_save_directory(tmp_path, low_res):
    gen, disc = _configs()
    jmodel = JaxGan(gen, disc, **_kwargs())
    jmodel.init_weights(LR_SHAPE, HR_SHAPE, seed=5)
    jmodel.save(str(tmp_path))
    model = Sup3rGan.load(str(tmp_path), device='cpu')
    assert model.meta['lr_features'] == FEATURES
    assert (model.s_enhance, model.t_enhance) == (3, 4)
    np.testing.assert_allclose(model.generate(low_res),
                               jmodel.generate(low_res), rtol=RTOL,
                               atol=ATOL)
    # the discriminator's weights came across too
    hr = np.random.default_rng(2).standard_normal(HR_SHAPE).astype(
        np.float32)
    with torch.no_grad():
        got = model.discriminator.apply(torch.from_numpy(hr)).numpy()
    want = np.asarray(jmodel.discriminator.apply(jmodel.disc_params, hr))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fast_mode_is_not_ported(models, low_res):
    """Fast mode on this file's generator: the subpixel tail and a bf16
    body, within 0.04 of the largest magnitude of the JAX package's fast
    output and of the port's exact output (docs/PERFORMANCE.md "Fast
    inference mode"); 'exact' restores the exact route."""
    jmodel, model = models
    exact = model.generate(low_res)
    for m in models:
        m.inference_mode = 'fast'
    try:
        want, got = (m.generate(low_res) for m in models)
    finally:
        for m in models:
            m.inference_mode = 'exact'
    assert got.dtype == np.float32 and got.shape == exact.shape
    scale = float(np.abs(want).max())
    assert 0 < float(np.abs(got - exact).max()) <= 0.04 * scale
    assert float(np.abs(got - want).max()) <= 0.04 * scale
    assert model.inference_mode == 'exact'
    np.testing.assert_array_equal(model.generate(low_res), exact)


def test_layer_exo_matches_jax():
    """A plain {feature: array} exo dict, and the structured ExoData
    form, reach a Sup3rConcat layer, normalized with the feature's own
    stats, as in the JAX package."""
    gen = [{'class': 'Sup3rConcat', 'name': 'topography'},
           {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3,
            'padding': 'same'}]
    disc = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    kw = _kwargs()
    kw['means']['topography'] = 100.0
    kw['stdevs']['topography'] = 50.0
    jmodel = JaxGan(gen, disc, **kw)
    jmodel.init_weights((2, 5, 4, 2), (2, 5, 4, 2))
    model = Sup3rGan(gen, disc, device='cpu', **kw)
    model.init_weights((2, 5, 4, 2), (2, 5, 4, 2))
    params_from_jax(model.generator,
                    jax.tree.map(np.asarray, jmodel.gen_params))
    rng = np.random.default_rng(4)
    lr = rng.standard_normal((2, 5, 4, 2)).astype(np.float32)
    exo = {'topography': (rng.random((5, 4, 1)) * 300).astype(np.float32)}
    np.testing.assert_allclose(
        model.generate(lr, exogenous_data=exo),
        jmodel.generate(lr, exogenous_data=exo), rtol=RTOL, atol=ATOL)
    steps = {'topography': {'steps': [
        {'model': 0, 'combine_type': 'layer', 'data': exo['topography']}]}}
    np.testing.assert_allclose(
        model.generate(lr, exogenous_data=steps),
        jmodel.generate(lr, exogenous_data=steps), rtol=RTOL, atol=ATOL)


def test_save_params_reads_back_in_jax(models, tmp_path):
    """The port writes the JAX package's model_params.json."""
    _, model = models
    model.save_params(str(tmp_path))
    params = JaxGan.load_saved_params(str(tmp_path))
    assert params['meta']['class'] == 'Sup3rGan'
    assert params['gen_config'] == model.generator.config
    assert tuple(params['gen_in_shape']) == LR_SHAPE
    assert params['means'] == _kwargs()['means']
    assert 'torch' in params['version_record']
