"""Gradients of the port's two differentiable reflect-conv blocks against
``jax.vjp`` of the JAX package's: ``ops/conv_ad.py``'s
``reflect_conv_ad`` (its custom VJP) and ``pallas_kernels.
small_reflect_conv`` (the Pallas kernel in interpret mode, with its
``_small_conv_bwd``). On CPU tensors the port's ``small_reflect_conv``
Function runs its kernel's plain version forward and the shared custom
backward. Tolerance: 1e-5 of each gradient's largest magnitude (fp32,
the same sums in another order). A float64 ``gradcheck`` holds the
backward formulas to finite differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sup3r_tpu.ops import conv_ad as jconv
from sup3r_tpu.ops import pallas_kernels as pk
from sup3r_tpu_torch.ops import kernels as tk
from sup3r_tpu_torch.ops.conv_ad import reflect_conv_ad
from test_torch_kernels import interpret  # noqa: F401 (fixture)

torch.set_num_threads(1)

RTOL = 1e-5


def _inputs(seed, x_shape, co, zero_block=False):
    """Channels-last x, DHWIO/HWIO kernel, bias and output cotangent.
    ``zero_block`` zeroes a block of x and the bias, so the
    pre-activation is exactly 0 on the cells that read only that
    block: where LeakyReLU's gradient convention shows."""
    rng = np.random.default_rng(seed)
    n_spatial = len(x_shape) - 2
    x = rng.standard_normal(x_shape).astype(np.float32)
    k = (rng.standard_normal((3,) * n_spatial + (x_shape[-1], co))
         / np.sqrt(3 ** n_spatial * x_shape[-1])).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    if zero_block:
        x[:, :4, :4] = 0
        b[:] = 0
    dy = rng.standard_normal((*x_shape[:-1], co)).astype(np.float32)
    return x, k, b, dy


def _jax_grads(fn, x, k, b, dy):
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _port_grads(fn, x, k, b, dy):
    """(dx, dkernel, dbias) of a channels-first port function, in the
    JAX package's layouts."""
    n = x.ndim - 2
    xt = torch.from_numpy(x).movedim(-1, 1).contiguous().requires_grad_()
    wt = torch.from_numpy(k).permute(n + 1, n, *range(n)).contiguous()
    wt.requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = fn(xt, wt, bt)
    gx, gw, gb = torch.autograd.grad(
        y, (xt, wt, bt), torch.from_numpy(dy).movedim(-1, 1))
    return [gx.movedim(1, -1).numpy(),
            gw.permute(*range(2, 2 + n), 1, 0).numpy(), gb.numpy()]


def _assert_close(got, want):
    for g, w, name in zip(got, want, ('dx', 'dkernel', 'dbias')):
        assert g.shape == w.shape, name
        tol = RTOL * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


@pytest.mark.parametrize('x_shape,co,alpha,zero_block', [
    ((2, 6, 5, 7, 3), 4, None, False),   # 3D
    ((2, 6, 5, 7, 3), 4, 0.2, False),
    ((2, 6, 5, 7, 3), 4, 0.0, True),     # exact-zero pre-activations
    ((1, 5, 4, 6, 8), 2, 0.2, True),
    ((2, 7, 6, 3), 5, None, False),      # 2D
    ((2, 7, 6, 3), 5, 0.2, True),
    ((2, 7, 6, 3), 5, 0.0, False),
])
def test_reflect_conv_ad_grads_match_jax(x_shape, co, alpha, zero_block):
    x, k, b, dy = _inputs(0, x_shape, co, zero_block)
    n = len(x_shape) - 2
    want = _jax_grads(
        lambda xx, kk, bb: jconv.reflect_conv_ad(xx, kk, bb, n, alpha),
        x, k, b, dy)
    got = _port_grads(
        lambda xx, ww, bb: reflect_conv_ad(xx, ww, bb, n, alpha),
        x, k, b, dy)
    _assert_close(got, want)


@pytest.mark.parametrize('x_shape,co,alpha,zero_block', [
    ((1, 5, 4, 6, 8), 2, None, False),   # the flagship tail's 8 -> 2
    ((1, 5, 4, 6, 8), 2, 0.2, True),     # exact-zero pre-activations
    ((1, 5, 4, 6, 8), 2, 0.0, True),
    ((1, 5, 4, 6, 8), 2, 0.0, False),
    ((2, 4, 5, 7, 8), 1, 0.2, False),    # 8 -> 1
    ((1, 4, 6, 5, 8), 3, None, True),    # 8 -> 3
])
def test_small_reflect_conv_grads_match_jax(interpret, x_shape, co, alpha,
                                            zero_block):
    x, k, b, dy = _inputs(1, x_shape, co, zero_block)
    want = _jax_grads(
        lambda xx, kk, bb: pk.small_reflect_conv(xx, kk, bb, alpha=alpha),
        x, k, b, dy)
    assert interpret, 'the JAX kernel did not run through pallas_call'
    got = _port_grads(
        lambda xx, ww, bb: tk.small_reflect_conv_cf(xx, ww, bb, alpha),
        x, k, b, dy)
    _assert_close(got, want)
    assert tk.small_reflect_conv_cf.launches == 0


def test_leaky_relu_gradient_at_zero_is_one():
    """At an exactly-zero pre-activation the JAX package's mask passes
    the gradient (``where(x >= 0, ...)``); torch's ``F.leaky_relu``
    would scale it by alpha. The zero block makes such cells."""
    x, k, b, dy = _inputs(2, (1, 6, 6, 6, 2), 2, zero_block=True)
    port = _port_grads(
        lambda xx, ww, bb: reflect_conv_ad(xx, ww, bb, 3, 0.2),
        x, k, b, dy)

    def torch_default(xx, ww, bb):
        xp = F.pad(xx, (1,) * 6, mode='reflect')
        return F.leaky_relu(F.conv3d(xp, ww, bb), 0.2)

    default = _port_grads(torch_default, x, k, b, dy)
    assert not np.allclose(port[2], default[2], rtol=1e-3), (
        'the zero block made no exactly-zero pre-activations')
    x_nz, *_ = _inputs(2, (1, 6, 6, 6, 2), 2)
    same = _port_grads(
        lambda xx, ww, bb: reflect_conv_ad(xx, ww, bb, 3, 0.2),
        x_nz, k, b, dy)
    other = _port_grads(torch_default, x_nz, k, b, dy)
    for g, w in zip(same, other):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('alpha', [None, 0.2, 0.0])
@pytest.mark.parametrize('fn,x_shape', [
    ('reflect_conv_ad', (1, 2, 4, 3, 5)),
    ('reflect_conv_ad', (2, 3, 4, 3)),
    ('small_reflect_conv', (1, 2, 3, 4, 5)),
])
def test_backward_formulas_gradcheck(fn, x_shape, alpha):
    """float64 finite differences against the custom backward."""
    gen = torch.Generator().manual_seed(3)
    n = len(x_shape) - 2
    x = torch.randn(x_shape, generator=gen, dtype=torch.float64)
    w = torch.randn((2, x_shape[1]) + (3,) * n, generator=gen,
                    dtype=torch.float64) / 3
    b = torch.randn(2, generator=gen, dtype=torch.float64)
    if fn == 'reflect_conv_ad':
        def f(xx, ww, bb):
            return reflect_conv_ad(xx, ww, bb, n, alpha)
    else:
        def f(xx, ww, bb):
            return tk.small_reflect_conv_cf(xx, ww, bb, alpha)
    assert torch.autograd.gradcheck(
        f, tuple(t.requires_grad_() for t in (x, w, b)), eps=1e-6,
        atol=1e-7)
