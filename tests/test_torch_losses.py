"""The port's content losses (``sup3r_tpu_torch/ops/losses.py``) against
the JAX package's on the same numpy inputs: every loss of
``get_loss_fun``'s registry and a multi-term spec, values at rtol 1e-5
and gradients in the synthetic input at 1e-4 of their largest magnitude
(fp32, other summation orders; the FFT losses sum over log-spectra)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sup3r_tpu.ops import losses as jl
from sup3r_tpu_torch.ops import losses as tl

torch.set_num_threads(1)

#: losses that need 5D (n, s1, s2, t, f) batches; the others take 4D too
FIVE_D = {'MaterialDerivativeLoss', 'TemporalDerivativeLoss',
          'TemporalExtremesLoss', 'TemporalExtremesOnlyLoss',
          'SpatiotemporalFftLoss', 'StExtremesFftLoss'}
#: losses whose 5D batches break their spatial-only frequency weights
FOUR_D = {'SpatialFftLoss'}
NAMES = sorted(k for k in tl.LOSS_REGISTRY
               if k not in ('SlicedWassersteinLoss',))


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _check(jfun, tfun, x1, x2):
    want, want_g = jax.jit(jax.value_and_grad(jfun))(jnp.asarray(x1),
                                                     jnp.asarray(x2))
    a = torch.from_numpy(x1).requires_grad_()
    got = tfun(a, torch.from_numpy(x2))
    got_g, = torch.autograd.grad(got, a)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=0,
                               atol=1e-4 * float(np.abs(want_g).max()))


def test_registries_name_the_same_losses():
    assert sorted(tl.LOSS_REGISTRY) == sorted(jl.LOSS_REGISTRY)


@pytest.mark.parametrize('name', NAMES)
def test_registry_loss_matches_jax(name):
    shape = (2, 6, 4, 8, 2) if name not in FOUR_D else (2, 6, 4, 2)
    x1, x2 = _pair(0, shape)
    _check(jl.get_loss_fun(name), tl.get_loss_fun(name), x1, x2)
    if name not in FIVE_D | FOUR_D | {'MaterialDerivativeLoss'}:
        x1, x2 = _pair(1, (2, 6, 4, 2))
        _check(jl.get_loss_fun(name), tl.get_loss_fun(name), x1, x2)


@pytest.mark.parametrize('spec', [
    [('MeanAbsoluteError', 0.5), ('SpatialDerivativeLoss', 2.0),
     ({'LowResLoss': {'s_enhance': 2, 't_enhance': 4,
                      'ex_loss': 'TemporalExtremesLoss'}}, 1.0)],
    {'LowResLoss': {'s_enhance': 3, 't_enhance': 2,
                    't_method': 'subsample',
                    'tf_loss': 'MeanAbsoluteError'}},
    {'MmdLoss': {'sigma': 2.0}},
])
def test_spec_loss_matches_jax(spec):
    x1, x2 = _pair(2, (2, 6, 6, 8, 2))
    _check(jl.get_loss_fun(spec), tl.get_loss_fun(spec), x1, x2)


def test_perceptual_loss_with_vgg_weights_matches_jax():
    rng = np.random.default_rng(3)
    weights = {'block1_conv1/kernel': rng.standard_normal((3, 3, 3, 4)),
               'block1_conv1/bias': rng.standard_normal(4),
               'block1_conv2_kernel': rng.standard_normal((3, 3, 4, 4)),
               'block1_conv2_bias': rng.standard_normal(4)}
    x1, x2 = _pair(4, (1, 6, 4, 4, 1))
    x1, x2 = 100 * x1 + 100, 100 * x2 + 100
    kw = {'weights': weights, 'layer_names': ['block1_conv2']}
    _check(jl.PerceptualLoss(**kw), tl.PerceptualLoss(**kw), x1, x2)


def test_perceptual_weights_are_the_jax_packages():
    with np.load(jl.PerceptualLoss.WEIGHTS_V1) as a, \
            np.load(tl.PerceptualLoss.WEIGHTS_V1) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize('shape', [(2, 5, 4, 3, 2), (2, 5, 4, 2)])
def test_sliced_wasserstein_matches_jax_on_the_same_projections(shape):
    """The JAX package draws its projections from a PRNG key (the
    instance seed when none is given), the port from a
    ``torch.Generator``; fed JAX's projections, the port's distance is
    JAX's."""
    x1, x2 = _pair(5, shape)
    hwt = int(np.prod(shape[1:-1]))
    jloss = jl.SlicedWassersteinLoss(n_projections=16, seed=3)
    proj = jax.random.normal(jax.random.PRNGKey(3), (16, hwt))
    proj = np.array(proj / jnp.linalg.norm(proj, axis=-1, keepdims=True))
    tloss = tl.SlicedWassersteinLoss(n_projections=16, seed=3)
    _check(jloss, lambda a, b: tloss.project(a, b, torch.from_numpy(proj)),
           x1, x2)
    gen = torch.Generator().manual_seed(0)
    drawn = tloss.projections(torch.from_numpy(x1), gen)
    assert drawn.shape == (16, hwt)
    np.testing.assert_allclose(drawn.norm(dim=-1).numpy(), 1, rtol=1e-6)


def test_apply_loss_threads_the_generator():
    swl = tl.get_loss_fun([('MeanSquaredError', 1.0),
                           ({'SlicedWassersteinLoss': {
                               'n_projections': 8}}, 0.5)])
    assert swl.needs_generator
    x1, x2 = (torch.from_numpy(a) for a in _pair(6, (1, 4, 4, 3, 1)))
    seeded = [tl.apply_loss(swl, x1, x2,
                            generator=torch.Generator().manual_seed(1))
              for _ in range(2)]
    assert float(seeded[0]) == float(seeded[1])
    other = tl.apply_loss(swl, x1, x2,
                          generator=torch.Generator().manual_seed(2))
    assert float(other) != float(seeded[0])
    assert not getattr(tl.get_loss_fun('MeanSquaredError'),
                       'needs_generator', False)


def test_unknown_loss_and_bad_method_raise():
    with pytest.raises(KeyError, match='Unknown loss'):
        tl.get_loss_fun('NoSuchLoss')
    with pytest.raises(ValueError, match='t_method'):
        tl.LowResLoss(t_enhance=2, t_method='avg')
