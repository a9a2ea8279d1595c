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
- wgrad: on the card, for float32 3D blocks at the shapes where it was
  timed faster (``wgrad_kernel_wins``), the hand-written
  ``reflect_conv_wgrad`` kernel (``csrc/reflect_conv_wgrad.cu``: 3xTF32
  on the tensor cores, its reflect halo made by index math, so no padded
  copy of the input; it replaces no Pallas kernel: the JAX package
  leaves the weight gradient to XLA); otherwise cuDNN's native weight
  gradient on the padded input (the kernel's plain version,
  ``reflect_conv_wgrad_reference``). While a profiler records, each weight
  gradient counts ``conv_ad.wgrad_kernel`` or ``conv_ad.wgrad_cudnn`` by
  the route it ran (``utilities/trace.py``).

Every step runs in the gradient's dtype: float32, or bf16 in bf16
training (``train_dtype``; its wgrad stays on cuDNN).
``small_reflect_conv_cf`` (``ops/kernels.py``) shares this backward; the
sharded formulations below have backwards of their own, on cuDNN.

``reflect_conv_shard_aligned`` is the JAX package's shard-aligned s1
formulation (zero s1 pad inside the conv, the two boundary rows
corrected), with the custom backward of its ``_sa_bwd``.
``reflect_conv_halo`` is the route of a block of s1 rows under a
spatial mesh: the neighbours' boundary rows (or the block's own reflect
row at a global edge) above and below, then a conv that is valid on s1,
with the shard-local form of the shard-aligned backward
(``ReflectConvHalo``).
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from sup3r_tpu_torch.ops import build
from sup3r_tpu_torch.utilities import trace
from sup3r_tpu_torch.utilities.flops import count_kernel_conv

__all__ = ['reflect_conv_ad', 'reflect_conv_backward', 'reflect_conv_halo',
           'reflect_conv_shard_aligned', 'reflect_conv_wgrad',
           'reflect_conv_wgrad_reference', 'shard_aligned_worthwhile',
           'wgrad_kernel_wins']


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
    return (F.conv1d, F.conv2d, F.conv3d)[n_spatial - 1]


def _conv_weight_grad(n_spatial):
    grad = torch.nn.grad
    return (grad.conv1d_weight, grad.conv2d_weight,
            grad.conv3d_weight)[n_spatial - 1]


def shard_aligned_worthwhile(spatial_width):
    """Whether the JAX package's shard-aligned s1 formulation pays off
    on a spatial mesh axis of this width (>= 4: at 2 its XLA partitioner
    already moves 1-row halos): the gate of ``train_shard_aligned=None``.
    The port's halo route exchanges one row each way at any width in
    either formulation; the gate picks the route of the blocks the small
    kernel takes (``models.fuse.FusedReflectConv``)."""
    return int(spatial_width) >= 4


def _fold_reflect_halos(gxp, n_spatial, start=0):
    """Exact transpose of the 1-cell reflect pad on the spatial dims
    from ``start`` on of a channels-first gradient, one dim at a time:
    inner cell ``i`` takes the padded gradient at ``i + 1``; cells 1 and
    S-2 absorb the reflected halo gradients. Halo slabs keep the other
    dims' padding, so corner contributions compose as the nested forward
    pads did. Shared by the plain and shard-aligned backwards."""
    for d in range(2 + start, 2 + n_spatial):
        n = gxp.shape[d]
        gx = gxp.narrow(d, 1, n - 2).clone()
        gx.narrow(d, 1, 1).add_(gxp.narrow(d, 0, 1))
        gx.narrow(d, n - 4, 1).add_(gxp.narrow(d, n - 1, 1))
        gxp = gx
    return gxp


#: output cells (batch times volume), the weight gradient's K sum, from
#: which the hand-written ``reflect_conv_wgrad`` takes a block's weight
#: gradient (``wgrad_kernel_wins``)
WGRAD_KERNEL_MIN_CELLS = 16384


def wgrad_kernel_wins(x, dy):
    """Whether a fused block's weight gradient at input ``x`` and output
    gradient ``dy`` runs on the hand-written ``reflect_conv_wgrad``
    kernel: float32 3D tensors on the card of at least
    ``WGRAD_KERNEL_MIN_CELLS`` output cells. Set from both routes timed
    on an H100 and held to float64 (chip_smoke.py phase 2c; PERF.md's
    kernel table). The cut is the kernel's error: on blocks of 1 to 8
    input channels the worst of 12 seeds carried 2.0 to 2.2 times cuDNN
    fp32's largest error against float64 at 7,200 to 12,288 cells (both
    errors near fp32 rounding there, 3e-7 to 8e-7 of max |dW|: the
    kernel's 3xTF32 products against cuDNN's short fp32 sums), and at
    most 1.71 times from 13,824 cells on (1.57 at 16,384); at 12 or more
    input channels at most 0.5 times at any size. From 16,384 cells on
    the kernel was 1.6x to 53x faster; the train cell's blocks, and every
    shipped generator's at batch 16, have 27,648 cells or more. bf16
    training, 2D blocks and CPU tensors keep the library route
    (``reflect_conv_wgrad_reference``); the sharded blocks' backwards
    (``ReflectConvShardAligned``, ``ReflectConvHalo``) never ask."""
    n, _, *spatial = x.shape
    return (x.is_cuda and x.dtype == dy.dtype == torch.float32
            and len(spatial) == 3 and min(spatial) >= 2
            and n * math.prod(spatial) >= WGRAD_KERNEL_MIN_CELLS)


def reflect_conv_wgrad_reference(x, dy):
    """The weight gradient of a reflect-pad-1 k3 conv (2D or 3D) at
    ``dy``: the library's (cuDNN's on the card) native weight gradient on
    a reflect-padded copy of ``x``. The plain version of
    ``reflect_conv_wgrad``."""
    n_spatial = x.ndim - 2
    xp = F.pad(x, (1, 1) * n_spatial, mode='reflect')
    shape = (dy.shape[1], x.shape[1]) + (3,) * n_spatial
    return _conv_weight_grad(n_spatial)(xp, shape, dy)


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_WGRAD_SCRATCH = ('reflect_conv_wgrad', 'reflect_conv_wgrad_scratch',
                  [_INT] * 7 + [_PTR])
_WGRAD_LAUNCH = ('reflect_conv_wgrad', 'reflect_conv_wgrad_tf32x3',
                 [_PTR] * 5 + [_INT] * 7 + [_PTR])


def reflect_conv_wgrad(x, dy):
    """The weight gradient of a reflect-pad-1 + k3/s1 3D conv at ``dy``:
    ``dW[co, ci, tap] = sum over (n, cell) of dy[n, co, cell] *
    x[n, ci, reflect(cell + tap - 1)]``. x: (n, ci, s0, s1, s2) float32;
    dy: (n, co, s0, s1, s2). Returns (co, ci, 3, 3, 3). A CUDA tensor
    launches ``csrc/reflect_conv_wgrad.cu`` (the packing of dy, the
    split-K GEMM in 3xTF32 and the ordered reduction of its partials, on
    scratch made here); a CPU tensor takes the plain version
    (``reflect_conv_wgrad_reference``). The count ``launches`` moves
    once a call on the card, and each launch reports its FLOPs to
    ``utilities.flops.estimate_flops``."""
    if x.ndim != 5 or dy.ndim != 5 or dy.shape[0] != x.shape[0] or (
            dy.shape[2:] != x.shape[2:]):
        raise ValueError(
            f'reflect_conv_wgrad: expected 5D x and dy of one batch and '
            f'spatial shape; got {tuple(x.shape)} and {tuple(dy.shape)}')
    if x.device.type == 'cpu':
        return reflect_conv_wgrad_reference(x, dy)
    if x.device.type != 'cuda' or dy.device != x.device or not (
            x.dtype == dy.dtype == torch.float32):
        raise ValueError(
            f'reflect_conv_wgrad: the CUDA kernel takes float32 tensors on '
            f'one device; got x {x.dtype} on {x.device}, dy {dy.dtype} on '
            f'{dy.device}')
    if min(x.shape[2:]) < 2:
        raise ValueError(f'reflect_conv_wgrad: reflect padding needs every '
                         f'spatial dim >= 2, got {tuple(x.shape[2:])}')
    x, dy = x.contiguous(), dy.contiguous()
    n, ci, s0, s1, s2 = x.shape
    co = dy.shape[1]
    device = x.device.index
    sizes = (ctypes.c_longlong * 2)()
    err = build.c_function(*_WGRAD_SCRATCH)(
        n, ci, co, s0, s1, s2, device, ctypes.addressof(sizes))
    if err:
        raise RuntimeError(f'reflect_conv_wgrad: no launch plan for x '
                           f'{tuple(x.shape)} -> {co}: CUDA error {err}')
    packed = torch.empty(sizes[0], device=x.device, dtype=x.dtype)
    partial = torch.empty(sizes[1], device=x.device, dtype=x.dtype)
    dw = torch.empty((co, ci, 3, 3, 3), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.c_function(*_WGRAD_LAUNCH)(
        x.data_ptr(), dy.data_ptr(), packed.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), n, ci, co, s0, s1, s2, device, stream)
    if err:
        raise RuntimeError(f'reflect_conv_wgrad launch failed: CUDA error '
                           f'{err}')
    reflect_conv_wgrad.launches += 1
    count_kernel_conv(x.shape, co)
    return dw


reflect_conv_wgrad.launches = 0


def reflect_conv_backward(dy, x, weight, n_spatial, alpha, pre,
                          needs=(True, True, True)):
    """(dx, dweight, dbias) of reflect-pad-1 -> k3 conv -> +bias ->
    LeakyReLU(alpha) at ``dy``. ``pre`` decides the activation's mask
    (``pre >= 0`` passes the gradient, else it is scaled by ``alpha``):
    the pre-activation, or for ``alpha > 0`` the output. ``needs`` skips
    the gradients nobody asked for."""
    if alpha is not None:
        # in dy's dtype (bf16 in bf16 training); dy * 1 is dy exactly
        dy = torch.where(pre >= 0, dy, dy * float(alpha))
    conv = _conv(n_spatial)
    dx = dw = db = None
    if needs[2]:
        db = dy.sum(dim=[0, *range(2, dy.ndim)])
    if needs[0]:
        kf = weight.flip(list(range(2, 2 + n_spatial))).transpose(0, 1)
        dx = _fold_reflect_halos(conv(dy, kf, padding=2), n_spatial)
    if needs[1]:
        if wgrad_kernel_wins(x, dy):
            trace.count('conv_ad.wgrad_kernel')
            dw = reflect_conv_wgrad(x, dy)
        else:
            trace.count('conv_ad.wgrad_cudnn')
            dw = reflect_conv_wgrad_reference(x, dy)
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
