"""Reflect-pad-1 + valid k3 conv + bias + activation block, with a custom
backward (the port of ``sup3r_tpu/ops/conv_ad.py::reflect_conv_ad``).

The fused generator blocks run this composition by default: a 1-cell
reflect pad (``F.pad``), then ``F.conv3d`` / ``F.conv2d`` with the bias,
then LeakyReLU. On the card the convolution goes to cuDNN, as the JAX
package left it to XLA's conv emitter. Tensors are channels-first:
``(n, c, s1, s2[, t])`` with OI.. kernels.

Autograd would differentiate ``F.pad(mode='reflect') -> conv`` into a
conv dgrad on the padded input plus the reflect pad's own backward; the
custom backward (``reflect_conv_backward``) instead runs:

- the LeakyReLU mask ``where(pre >= 0, 1, alpha)`` on the saved
  pre-activation (``jax.nn.leaky_relu``'s gradient at exactly 0 is 1);
- ``dbias``, the sum of the masked gradient;
- dgrad as ONE conv of the gradient with the spatially flipped,
  IO-swapped kernel and full (2, 2) padding, which gives the gradient of
  the padded input, then ``_fold_reflect_halos``: inner cell ``i`` takes
  the padded gradient at ``i + 1``, and cells 1 and S-2 absorb the halo;
- wgrad as cuDNN's native weight gradient on the padded input.

``small_reflect_conv_cf`` (``ops/kernels.py``) shares this backward.
The shard-aligned variant comes with the multi-device slice (ROADMAP
queue 1 item 9).
"""

import torch
import torch.nn.functional as F

__all__ = ['reflect_conv_ad', 'reflect_conv_backward']


def _check_k3(weight, n_spatial):
    """The fused block is a k=3 reflect-boundary conv on every spatial
    dim; any other kernel would silently compute something else (and
    the backward hard-codes the k=3 transpose)."""
    taps = tuple(weight.shape[2:])
    if taps != (3,) * n_spatial:
        raise ValueError(
            f'reflect_conv ops require a k=3 kernel on every spatial '
            f'dim; got spatial taps {taps} (weight shape '
            f'{tuple(weight.shape)})')


def _conv(n_spatial):
    return F.conv3d if n_spatial == 3 else F.conv2d


def _fold_reflect_halos(gxp, n_spatial):
    """Exact transpose of the 1-cell reflect pad on every spatial dim of
    a channels-first gradient, one dim at a time: inner cell ``i`` takes
    the padded gradient at ``i + 1``; cells 1 and S-2 absorb the
    reflected halo gradients. Halo slabs keep the other dims' padding, so
    corner contributions compose as the nested forward pads did."""
    for d in range(2, 2 + n_spatial):
        n = gxp.shape[d]
        gx = gxp.narrow(d, 1, n - 2).clone()
        gx.narrow(d, 1, 1).add_(gxp.narrow(d, 0, 1))
        gx.narrow(d, n - 4, 1).add_(gxp.narrow(d, n - 1, 1))
        gxp = gx
    return gxp


def reflect_conv_backward(dy, x, weight, n_spatial, alpha, pre,
                          needs=(True, True, True)):
    """(dx, dweight, dbias) of reflect-pad-1 -> k3 conv -> +bias ->
    LeakyReLU(alpha) at ``dy``. ``pre`` decides the activation's mask
    (``pre >= 0`` passes the gradient, else it is scaled by ``alpha``):
    the pre-activation, or for ``alpha > 0`` the output. ``needs`` skips
    the gradients nobody asked for."""
    if alpha is not None:
        dy = dy * torch.where(pre >= 0, 1.0, float(alpha)).to(dy.dtype)
    conv = _conv(n_spatial)
    dx = dw = db = None
    if needs[2]:
        db = dy.sum(dim=[0, *range(2, dy.ndim)])
    if needs[0]:
        kf = weight.flip(list(range(2, 2 + n_spatial))).transpose(0, 1)
        dx = _fold_reflect_halos(conv(dy, kf, padding=2), n_spatial)
    if needs[1]:
        xp = F.pad(x, (1, 1) * n_spatial, mode='reflect')
        grad = (torch.nn.grad.conv3d_weight if n_spatial == 3
                else torch.nn.grad.conv2d_weight)
        dw = grad(xp, weight.shape, dy)
    return dx, dw, db


class ReflectConvAD(torch.autograd.Function):
    """reflect-pad-1 -> k3/s1 valid conv -> +bias -> LeakyReLU, with the
    custom backward of ``reflect_conv_backward``."""

    @staticmethod
    def forward(ctx, x, weight, bias, n_spatial, alpha):
        xp = F.pad(x, (1, 1) * n_spatial, mode='reflect')
        pre = _conv(n_spatial)(xp, weight, bias)
        # F.leaky_relu's values are jax.nn.leaky_relu's; its gradient at
        # exactly 0 is not, which the backward's mask takes care of
        y = pre if alpha is None else F.leaky_relu(pre, alpha)
        ctx.save_for_backward(x, weight, None if alpha is None else pre)
        ctx.n_spatial, ctx.alpha = n_spatial, alpha
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, pre = ctx.saved_tensors
        dx, dw, db = reflect_conv_backward(
            dy, x, weight, ctx.n_spatial, ctx.alpha, pre,
            ctx.needs_input_grad[:3])
        return dx, dw, db, None, None


def reflect_conv_ad(x, weight, bias, n_spatial, alpha):
    """reflect-pad-1 -> k3/s1 valid conv -> +bias -> LeakyReLU(alpha).

    x: (n, ci, *spatial); weight: (co, ci, 3, 3[, 3]); bias: (co,).
    ``alpha=None`` skips the activation. The forward is the unfused
    composition's; the backward is ``reflect_conv_backward``."""
    _check_k3(weight, n_spatial)
    return ReflectConvAD.apply(x, weight, bias, n_spatial, alpha)
