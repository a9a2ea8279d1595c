"""The port's subpixel tail (``sup3r_tpu_torch/ops/subpixel.py``,
``models/fuse.py`` ``SubpixelTailConv`` / ``fuse_subpixel_tail``) against
the JAX package's on the same seeded numpy inputs: the block-sparse
kernel and the phase-remapped pad exactly (after the channels-first
layout transpose), the tail conv in float32 within rtol = atol = 2e-5
over the parametrization of tests/models/test_subpixel.py, its gradients
within 3e-5, and the flagship's fused structure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sup3r_tpu.configs import get_config
from sup3r_tpu.ops import subpixel as jax_subpixel
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.fuse import (
    FusedReflectConv,
    SubpixelTailConv,
    fuse_network,
    fuse_subpixel_tail,
)
from sup3r_tpu_torch.models.layers import SpatioTemporalExpansion
from sup3r_tpu_torch.ops import subpixel

torch.set_num_threads(1)


def _cf(x):
    """Channels-last numpy -> channels-first tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(
        0, x.ndim - 1, *range(1, x.ndim - 1))


def _cl(t):
    return t.detach().permute(0, *range(2, t.ndim), 1).numpy()


def _oi(kernel):
    """DHWIO numpy kernel -> OIDHW tensor."""
    return torch.from_numpy(kernel).permute(4, 3, 0, 1, 2)


def _inputs(seed, m, ci, co, shape):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((*shape, m * m * ci)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, ci, co)).astype(np.float32)
    b = (rng.standard_normal(co) * 0.1).astype(np.float32)
    return z, k, b


@pytest.mark.parametrize('m', [2, 3])
def test_build_subpixel_kernel_equals_jax(m):
    _, k, _ = _inputs(0, m, 4, 3, (1, 2, 2, 2))
    want = np.asarray(jax_subpixel.build_subpixel_kernel(jnp.asarray(k), m))
    got = subpixel.build_subpixel_kernel(_oi(k), m).numpy()
    np.testing.assert_array_equal(got, want.transpose(4, 3, 0, 1, 2))


@pytest.mark.parametrize('m', [2, 3])
def test_phase_reflect_pad_equals_jax(m):
    z, _, _ = _inputs(1, m, 3, 2, (2, 4, 3, 5))
    want = np.asarray(jax_subpixel._phase_reflect_pad(jnp.asarray(z), m, 3))
    got = _cl(subpixel._phase_reflect_pad(_cf(z), m, 3))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('m,ci,co,shape', [
    (3, 8, 2, (2, 5, 4, 6)),
    (2, 4, 3, (1, 3, 5, 4)),
    (3, 2, 2, (2, 2, 2, 3)),
])
@pytest.mark.parametrize('alpha_prev', [None, 0.2])
@pytest.mark.parametrize('alpha', [None, 0.2])
def test_subpixel_tail_conv_matches_jax(m, ci, co, shape, alpha_prev,
                                        alpha):
    z, k, b = _inputs(2, m, ci, co, shape)
    want = np.asarray(jax_subpixel.subpixel_tail_conv(
        jnp.asarray(z), jnp.asarray(k), jnp.asarray(b), m,
        alpha_prev=alpha_prev, alpha=alpha))
    got = _cl(subpixel.subpixel_tail_conv(
        _cf(z), _oi(k), torch.from_numpy(b), m, alpha_prev=alpha_prev,
        alpha=alpha))
    assert got.shape == want.shape == (shape[0], m * shape[1],
                                       m * shape[2], shape[3], co)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_subpixel_tail_conv_gradients_match_jax():
    """dz, the HR kernel's and the bias's gradients (the kernel is built
    with differentiable ops, so the gradient reaches the HR weight)."""
    m, ci, co = 3, 4, 2
    z, k, b = _inputs(3, m, ci, co, (1, 3, 3, 4))
    cot = np.random.default_rng(4).standard_normal(
        (1, 9, 9, 4, co)).astype(np.float32)

    def loss(z, k, b):
        return jnp.sum(jax_subpixel.subpixel_tail_conv(
            z, k, b, m, alpha_prev=0.2) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(z), jnp.asarray(k), jnp.asarray(b))
    leaves = [_cf(z).clone().requires_grad_(),
              _oi(k).clone().requires_grad_(),
              torch.from_numpy(b).requires_grad_()]
    out = subpixel.subpixel_tail_conv(*leaves, m, alpha_prev=0.2)
    got = torch.autograd.grad((out * _cf(cot)).sum(), leaves)
    for name, g, w, back in (
            ('dz', got[0], want[0], _cl),
            ('dk', got[1], want[1],
             lambda t: t.permute(2, 3, 4, 1, 0).numpy()),
            ('db', got[2], want[2], lambda t: t.numpy())):
        np.testing.assert_allclose(back(g), np.asarray(w), rtol=3e-5,
                                   atol=3e-5, err_msg=name)


def test_fuse_subpixel_tail_on_the_flagship():
    """The structure tests/models/test_subpixel.py pins for the JAX
    flagship: the pre-tail activation is already folded into the
    previous conv by ``fuse_network``, so the rewrite collapses
    [expansion, tail] into one layer with ``alpha_prev`` None, and the
    fused tail reads the generator's own tail weight."""
    model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                     get_config('spatiotemporal/disc_test'), device='cpu')
    model.init_weights((1, 6, 6, 4, 2), (1, 18, 18, 16, 2), seed=0)
    flayers = fuse_network(list(model.generator.layers))
    slayers = fuse_subpixel_tail(flayers)
    assert isinstance(flayers[-2], SpatioTemporalExpansion)
    assert isinstance(flayers[-1], FusedReflectConv)
    assert isinstance(slayers[-1], SubpixelTailConv)
    assert len(slayers) == len(flayers) - 1
    assert slayers[-1].alpha_prev is None
    assert slayers[-1].m == 3
    assert slayers[-1].tail is flayers[-1]
    assert slayers[-1].tail.conv.weight is model.generator.layers[-2].weight
    # a list without the pattern passes through unchanged
    assert fuse_subpixel_tail(slayers) == slayers
