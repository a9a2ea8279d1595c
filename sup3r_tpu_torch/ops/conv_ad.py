"""The library formulations of the fused reflect-conv block (the port of
``sup3r_tpu/ops/conv_ad.py``), each with a custom backward, on
channels-first tensors (``(n, c, s1, s2[, t])``, OI.. kernels): reflect
pad, ``F.conv3d`` / ``F.conv2d`` (cuDNN on the card, as the JAX package
left the conv to XLA) and the activation. ``ops/kernels.py`` holds the
hand-written kernels a fused block may take instead and the rules that
choose.

- ``reflect_conv_ad``: its backward is ``kernels.reflect_conv_backward``
  (one full-padding dgrad conv and the reflect-halo fold in place of
  autograd's dgrad plus the pad's own backward), shared with the small
  kernel, in the gradient's dtype (bf16 in bf16 training).
- ``reflect_conv_shard_aligned``: the JAX package's shard-aligned s1
  formulation (zero s1 pad inside the conv, the two boundary rows
  corrected), with the backward of its ``_sa_bwd``.
- ``reflect_conv_halo``: a block of s1 rows under a spatial mesh with
  its neighbours' boundary rows (or its own reflect row at a global
  edge), valid on s1, with the shard-local form of the shard-aligned
  backward. Both sharded formulations take their wgrad on cuDNN.
"""

import torch
import torch.nn.functional as F

from sup3r_tpu_torch.ops.kernels import (
    _conv,
    _conv_weight_grad,
    _fold_reflect_halos,
    reflect_conv_backward,
    reflect_conv_reference,
)

__all__ = ['reflect_conv_ad', 'reflect_conv_halo',
           'reflect_conv_shard_aligned', 'shard_aligned_worthwhile']


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


def shard_aligned_worthwhile(spatial_width):
    """Whether the JAX package's shard-aligned s1 formulation pays off
    on a spatial mesh axis of this width (>= 4: at 2 its XLA partitioner
    already moves 1-row halos): the gate of ``train_shard_aligned=None``.
    The port's halo route exchanges one row each way at any width in
    either formulation; the gate picks the route of the blocks the small
    kernel takes (``models.fuse.FusedReflectConv``)."""
    return int(spatial_width) >= 4


class ReflectConvAD(torch.autograd.Function):
    """reflect-pad-1 -> k3/s1 valid conv -> +bias -> LeakyReLU: the
    forward of ``kernels.reflect_conv_reference`` with the custom backward
    of ``kernels.reflect_conv_backward``."""

    @staticmethod
    def forward(ctx, x, weight, bias, n_spatial, alpha):
        pre = reflect_conv_reference(x, weight, bias)
        # F.leaky_relu's values are jax.nn.leaky_relu's; its gradient at
        # exactly 0 is not, which the backward's mask takes care of
        y = _leaky(pre, alpha)
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


def _leaky(pre, alpha):
    return pre if alpha is None else F.leaky_relu(pre, alpha)


def _pad_st(x, n_spatial):
    """1-cell reflect pad of the spatial dims after s1 (s1 untouched)."""
    return F.pad(x, (1, 1) * (n_spatial - 1) + (0, 0), mode='reflect')


def _sa_forward(x, weight, bias, n_spatial):
    """The shard-aligned pre-activation: s2 (and t) reflect-padded, s1
    zero-padded inside the conv, and the two s1 boundary rows given the
    reflect contribution the zero pad dropped:
    ``out[0] += conv(x[1], weight[s1 tap 0])``,
    ``out[-1] += conv(x[-2], weight[s1 tap 2])``."""
    xp = _pad_st(x, n_spatial)
    y = _conv(n_spatial)(xp, weight, None,
                         padding=(1,) + (0,) * (n_spatial - 1))
    edge = _conv(n_spatial - 1)
    top = edge(xp[:, :, 1], weight[:, :, 0])
    bottom = edge(xp[:, :, -2], weight[:, :, 2])
    y = torch.cat([(y[:, :, :1] + top[:, :, None]), y[:, :, 1:-1],
                   (y[:, :, -1:] + bottom[:, :, None])], dim=2)
    return y + bias.view(-1, *[1] * n_spatial)


class ReflectConvShardAligned(torch.autograd.Function):
    """The shard-aligned block with the JAX package's custom backward
    (``sup3r_tpu/ops/conv_ad.py::_sa_bwd``): the dgrad keeps s1's (1, 1)
    zero pad plus two boundary-row terms, the s2 / t halos fold back as
    in ``reflect_conv_backward``, and the wgrad adds the two edge taps'
    gradients."""

    @staticmethod
    def forward(ctx, x, weight, bias, n_spatial, alpha):
        pre = _sa_forward(x, weight, bias, n_spatial)
        ctx.save_for_backward(x, weight, None if alpha is None else pre)
        ctx.n_spatial, ctx.alpha = n_spatial, alpha
        return _leaky(pre, alpha)

    @staticmethod
    def backward(ctx, dy):
        x, weight, pre = ctx.saved_tensors
        n, alpha = ctx.n_spatial, ctx.alpha
        if alpha is not None:
            dy = torch.where(pre >= 0, dy, dy * float(alpha))
        conv, edge = _conv(n), _conv(n - 1)
        db = dy.sum(dim=[0, *range(2, dy.ndim)])
        kf = weight.flip(list(range(2, 2 + n))).transpose(0, 1)
        gxp = conv(dy, kf, padding=(1,) + (2,) * (n - 1))
        # the boundary rows read xp[1] through tap 0 and xp[-2] through
        # tap 2
        edge_kf = [weight[:, :, tap].flip(list(range(2, 1 + n))).transpose(
            0, 1) for tap in (0, 2)]
        gxp[:, :, 1] += edge(dy[:, :, 0], edge_kf[0], padding=2)
        gxp[:, :, -2] += edge(dy[:, :, -1], edge_kf[1], padding=2)
        dx = _fold_reflect_halos(gxp, n, start=1)
        xp = _pad_st(x, n)
        dw = _conv_weight_grad(n)(xp, weight.shape, dy,
                                  padding=(1,) + (0,) * (n - 1))
        edge_grad = _conv_weight_grad(n - 1)
        dw[:, :, 0] += edge_grad(xp[:, :, 1], weight[:, :, 0].shape,
                                 dy[:, :, 0])
        dw[:, :, 2] += edge_grad(xp[:, :, -2], weight[:, :, 2].shape,
                                 dy[:, :, -1])
        return dx, dw, db, None, None


def reflect_conv_shard_aligned(x, weight, bias, n_spatial, alpha):
    """The math of ``reflect_conv_ad`` in the JAX package's shard-aligned
    s1 formulation (``sup3r_tpu/ops/conv_ad.py``): s1 zero-padded inside
    the conv and its two boundary rows corrected, s2 / t reflect-padded.
    Equal to ``reflect_conv_ad`` up to fp32 reassociation; 3D and 2D
    blocks (``n_spatial`` 3 or 2)."""
    _check_k3(weight, n_spatial)
    return ReflectConvShardAligned.apply(x, weight, bias, n_spatial, alpha)


def _halo_rows(x, top, bottom):
    """The block with its rows above and below: the neighbours' (``top``
    / ``bottom`` with rows), else at a global edge the block's own
    reflect row."""
    return torch.cat([top if top.shape[2] else x[:, :, 1:2], x,
                      bottom if bottom.shape[2] else x[:, :, -2:-1]], dim=2)


class ReflectConvHalo(torch.autograd.Function):
    """``reflect_conv_ad`` on a block of s1 rows (dim 2) with its halo
    rows, and its backward: the shard-local form of
    ``ReflectConvShardAligned``'s. The dgrad conv (full on s2 / t, valid
    on s1) and the wgrad run on the halo-padded block; the s2 / t halos
    fold back as in ``reflect_conv_backward``. The halo rows' gradients
    are returned as ``top`` / ``bottom``'s (the halo exchange's backward
    sends them to their owners). At a global edge (a 0-row ``top`` /
    ``bottom``) the reflect row's gradient folds into the block's row 1
    (or -2)."""

    @staticmethod
    def forward(ctx, x, top, bottom, weight, bias, n_spatial, alpha):
        xp = _pad_st(_halo_rows(x, top, bottom), n_spatial)
        pre = _conv(n_spatial)(xp, weight, bias)
        ctx.save_for_backward(x, top, bottom, weight,
                              None if alpha is None else pre)
        ctx.n_spatial, ctx.alpha = n_spatial, alpha
        return _leaky(pre, alpha)

    @staticmethod
    def backward(ctx, dy):
        x, top, bottom, weight, pre = ctx.saved_tensors
        n = ctx.n_spatial
        if ctx.alpha is not None:
            dy = torch.where(pre >= 0, dy, dy * float(ctx.alpha))
        db = dy.sum(dim=[0, *range(2, dy.ndim)])
        kf = weight.flip(list(range(2, 2 + n))).transpose(0, 1)
        # the gradient of the halo-padded, s2 / t-padded block
        gh = _fold_reflect_halos(_conv(n)(dy, kf, padding=2), n, start=1)
        xp = _pad_st(_halo_rows(x, top, bottom), n)
        dw = _conv_weight_grad(n)(xp, weight.shape, dy)
        dx = gh[:, :, 1:-1].clone()
        g_top, g_bottom = gh[:, :, :1], gh[:, :, -1:]
        if not top.shape[2]:  # the reflect row was x[1]
            dx[:, :, 1:2] += g_top
            g_top = top.new_zeros(top.shape)
        if not bottom.shape[2]:
            dx[:, :, -2:-1] += g_bottom
            g_bottom = bottom.new_zeros(bottom.shape)
        return dx, g_top, g_bottom, dw, db, None, None


def reflect_conv_halo(x, weight, bias, n_spatial, alpha, top=None,
                      bottom=None):
    """``reflect_conv_ad`` on a block of s1 rows (dim 2) of a tensor
    split over ranks: ``top`` / ``bottom`` are the neighbouring ranks'
    boundary rows (``halo_exchange``); at a global edge (None, or a
    tensor of 0 rows) the block's own reflect row stands in. The conv is valid on s1 and reflect-padded on s2 / t,
    so the rows out equal the unsplit conv's. Differentiable in ``x``,
    the halo rows, ``weight`` and ``bias`` (``ReflectConvHalo``)."""
    _check_k3(weight, n_spatial)
    if x.shape[2] < 2:
        raise ValueError(
            f'a spatially sharded reflect conv needs >= 2 s1 rows on each '
            f'rank (its reflect row at a global edge); got {x.shape[2]}')
    rows = (*x.shape[:2], 0, *x.shape[3:])
    top = x.new_empty(rows) if top is None else top
    bottom = x.new_empty(rows) if bottom is None else bottom
    return ReflectConvHalo.apply(x, top, bottom, weight, bias, n_spatial,
                                 alpha)
