"""Hand-written Hopper kernels for the fused reflect-conv blocks, with
their plain PyTorch versions and launch counters.

Both kernels compute the same function: a 1-cell reflect pad, a k3/s1
convolution, the bias and an optional LeakyReLU.

- ``small_reflect_conv_cf`` (``csrc/small_reflect_conv.cu``) replaces
  ``sup3r_tpu/ops/pallas_kernels.py::_small_conv_core`` (reached through
  ``small_reflect_conv``), for 3D convs with ``ci * co <= 32``: the
  flagship generator's HR 8 -> 2 tail. On an H100 SXM its bytes and
  its fp32 operations bound it alike (~0.07 ms at the flagship tail);
  each block stages its input window in shared memory one channel at a
  time (one tensor copy each), and each thread keeps a register
  block of outputs for up to 4 output channels. The wrapper lays out
  the weights per launch (``small_conv_pack_weights``).
- ``reflect_conv_cf`` (``csrc/reflect_conv.cu``) replaces
  ``sup3r_tpu/ops/pallas_kernels.py::reflect_conv``, in 2D and 3D: an
  implicit GEMM on the tensor cores (``wgmma``) in 3xTF32, fed by a
  cp.async / mbarrier ring. Each operand splits into a TF32 ``hi`` and
  ``lo`` (``split_tf32``); lo*hi + hi*lo + hi*hi keeps fp32-class
  accuracy (the dropped lo*lo is ~2^-22 relative), not bit equality
  with cuDNN. Bound by operations: ~0.82 ms per flagship body conv at
  an H100 SXM's dense TF32 rate, against ~2.0 ms for fp32 on the CUDA
  cores. The serving path takes it by default at the block shapes where
  it was timed faster than cuDNN's fp32 conv (``models/fuse.py``). The
  wrapper splits and lays out the weights at each launch
  (``pack_weights``); a fused block keeps its packing until its weight
  changes and launches ``reflect_conv_packed`` after
  ``reflect_conv_check``.

The weight gradient of these blocks in training has a kernel of its own,
``reflect_conv_wgrad`` (``csrc/reflect_conv_wgrad.cu``); it lives in
``ops/conv_ad.py`` with the backward that routes to it.

The source files carry each kernel's bound and design in full.

Wrappers take channels-first tensors (``(n, c, *spatial)``, OI.. weights):
the layout the port's network runs in. A tensor on the CPU takes the
plain version (``reflect_conv_reference``); a CUDA tensor launches the
kernel or raises. Each wrapper's ``launches`` attribute counts its kernel
launches (forward launches only); ``reflect_conv_cf.launches_by_rank``
splits its count by the input's spatial rank. Each launch also reports
its convolution's FLOPs to ``utilities.flops.estimate_flops``, which
cannot see a ``ctypes`` launch. ``small_reflect_conv`` and
``reflect_conv`` keep the JAX package's channels-last signatures for
tests and callers holding JAX layouts.

``small_reflect_conv_cf`` is differentiable, as the JAX package's
``small_reflect_conv`` is (its ``_small_conv_bwd``): a
``torch.autograd.Function`` whose backward is ``ops/conv_ad.py``'s
``reflect_conv_backward`` (the LeakyReLU mask, ``dbias``, a full-padding
dgrad with the flipped kernel plus the reflect-halo fold, and cuDNN's
native wgrad, or ``reflect_conv_wgrad`` on the card where it won).
``reflect_conv_cf`` has no backward in the JAX package and
is not on the training path: it raises on inputs that need gradients.
Both kernels take float32 only, as the JAX package's do: a bf16 block
never routes to the small kernel, and ``reflect_conv_cf`` refuses a bf16
input on the card (``REFLECT_CONV_FP32_ONLY``).
"""

import ctypes

import torch
import torch.nn.functional as F

from sup3r_tpu_torch.ops import build
from sup3r_tpu_torch.ops.conv_ad import (
    reflect_conv_ad,
    reflect_conv_backward,
)
from sup3r_tpu_torch.utilities.flops import count_kernel_conv

#: output channels ``small_reflect_conv_cf`` takes
SMALL_CONV_MAX_CO = 32
#: largest ci * co it takes; the network's gate is ci * co <= 32
SMALL_CONV_MAX_CI_CO = 455
#: output channels per block of ``csrc/small_reflect_conv.cu``; a larger
#: co runs in groups of this many
SMALL_CONV_CO_TILE = 4
#: output-channel tiles ``csrc/reflect_conv.cu`` is instantiated for
REFLECT_CONV_N_TILES = (32, 64, 72, 128)
#: input channels per K-step of ``csrc/reflect_conv.cu`` (tf32 wgmma k8)
REFLECT_CONV_K_STEP = 8

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'small_reflect_conv_f32': [_PTR] * 4 + [_INT] * 7 + [_FLOAT, _INT, _PTR],
    'reflect_conv_tf32x3': [_PTR] * 4 + [_INT] * 9 + [_FLOAT, _INT, _PTR],
}


#: why ``reflect_conv_cf`` refuses a bf16 input on the card
REFLECT_CONV_FP32_ONLY = (
    'reflect_conv takes float32 only, as the JAX package\'s Pallas '
    'reflect_conv does (its pad scratch is float32, '
    'sup3r_tpu/ops/pallas_kernels.py:123-126: a bf16 input fails while '
    'that kernel is traced). Fast mode (a bf16 body) with '
    'inference_pallas=True is refused; serve fast mode with '
    'inference_pallas=False (cuDNN\'s bf16 convs)')


def _c_function(lib_name, fn_name):
    """The C entry point ``fn_name`` of ``csrc/<lib_name>.cu``, built
    and loaded at first use."""
    return build.c_function(lib_name, fn_name, _SIGNATURES[fn_name])


def reflect_conv_reference(x, weight, bias, alpha=None):
    """Plain PyTorch version of both kernels: ``F.pad(mode='reflect')``,
    ``F.conv3d`` / ``F.conv2d`` with the bias, ``F.leaky_relu``."""
    return reflect_conv_ad(x, weight, bias, x.ndim - 2, alpha)


def _check_args(name, x, weight, bias, n_spatial):
    """Common validation; returns True when the kernel should launch
    (a CUDA tensor), False for the plain version (a CPU tensor)."""
    if x.ndim != 2 + n_spatial:
        raise ValueError(f'{name}: expected a {2 + n_spatial}D input, got '
                         f'shape {tuple(x.shape)}')
    co, ci = weight.shape[:2]
    if (tuple(weight.shape) != (co, x.shape[1]) + (3,) * n_spatial
            or tuple(bias.shape) != (co,)):
        raise ValueError(
            f'{name}: weight {tuple(weight.shape)} / bias '
            f'{tuple(bias.shape)} do not fit input {tuple(x.shape)}')
    if x.device.type == 'cpu':
        return False
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {x.device}')
    for t in (x, weight, bias):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(
                f'{name}: the CUDA kernel takes float32 tensors on one '
                f'device; got {t.dtype} on {t.device} beside x on '
                f'{x.device}')
    if min(x.shape[2:]) < 2:
        raise ValueError(f'{name}: reflect padding needs every spatial dim '
                         f'>= 2, got {tuple(x.shape[2:])}')
    return True


def _launch_args(x, bias):
    """Contiguous input and bias, and the device index and stream to
    launch on."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return x.contiguous(), bias.contiguous(), x.device.index, stream


def small_conv_pack_weights(weight):
    """OIDHW weight (co, ci, 3, 3, 3) -> the small kernel's order
    (co groups, ci, 9 (dh, dw), g): per (dh, dw), the 3 dt taps times
    ``cot = min(co, SMALL_CONV_CO_TILE)`` channels of a group, zero-padded
    to ``g``, the next multiple of 4 floats."""
    co, ci = weight.shape[:2]
    cot = min(co, SMALL_CONV_CO_TILE)
    groups = -(-co // cot)
    w = F.pad(weight, (0,) * 8 + (0, groups * cot - co))
    w = w.reshape(groups, cot, ci, 9, 3).permute(0, 2, 3, 4, 1)
    w = w.reshape(groups, ci, 9, 3 * cot)
    return F.pad(w, (0, -(-3 * cot // 4) * 4 - 3 * cot)).contiguous()


class SmallReflectConv(torch.autograd.Function):
    """The small kernel's forward (or its plain version on a CPU
    tensor) with ``reflect_conv_backward``. The LeakyReLU mask reads
    the output for ``alpha > 0`` (same sign as the pre-activation);
    for ``alpha == 0`` the kernel runs without the activation and the
    pre-activation is kept."""

    @staticmethod
    def forward(ctx, x, weight, bias, alpha, on_card):
        keep_pre = alpha is not None and alpha <= 0
        kernel_alpha = None if keep_pre else alpha
        if on_card:
            co = weight.shape[0]
            y = small_reflect_conv_packed(
                x, small_conv_pack_weights(weight), bias, co, kernel_alpha)
        else:
            with torch.no_grad():
                y = reflect_conv_reference(x, weight, bias, kernel_alpha)
        mask = None
        if keep_pre:
            mask, y = y, F.leaky_relu(y, alpha)
        elif alpha is not None:
            mask = y
        ctx.save_for_backward(x, weight, mask)
        ctx.alpha = alpha
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mask = ctx.saved_tensors
        dx, dw, db = reflect_conv_backward(
            dy, x, weight, 3, ctx.alpha, mask, ctx.needs_input_grad[:3])
        return dx, dw, db, None, None


def small_reflect_conv_cf(x, weight, bias, alpha=None):
    """Reflect-pad-1 + k3 3D conv + bias (+LeakyReLU) for tiny channel
    counts. x: (B, CI, H, W, T) float32; weight: (CO, CI, 3, 3, 3);
    bias: (CO,). Returns (B, CO, H, W, T). Differentiable in x, weight
    and bias (``SmallReflectConv``); the count ``launches`` moves with
    forward launches only."""
    on_card = _check_args('small_reflect_conv', x, weight, bias, 3)
    if on_card:
        co, ci = weight.shape[:2]
        if not 1 <= co <= SMALL_CONV_MAX_CO or (
                ci * co > SMALL_CONV_MAX_CI_CO):
            raise ValueError(
                f'small_reflect_conv is built for 1 <= co <= '
                f'{SMALL_CONV_MAX_CO} with ci * co <= '
                f'{SMALL_CONV_MAX_CI_CO}; got ci={ci}, co={co}')
    if not (torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias))):
        if not on_card:
            return reflect_conv_reference(x, weight, bias, alpha)
        return small_reflect_conv_packed(
            x, small_conv_pack_weights(weight), bias, weight.shape[0],
            alpha)
    return SmallReflectConv.apply(x, weight, bias, alpha, on_card)


small_reflect_conv_cf.launches = 0


def small_reflect_conv_packed(x, packed, bias, co, alpha=None):
    """The launch of ``small_reflect_conv_cf`` alone, on a CUDA input it
    has checked and weights laid out by ``small_conv_pack_weights``."""
    fn = _c_function('small_reflect_conv', 'small_reflect_conv_f32')
    x, b, device, stream = _launch_args(x, bias)
    B, ci, H, W, T = x.shape
    y = torch.empty((B, co, H, W, T), device=x.device, dtype=x.dtype)
    err = fn(x.data_ptr(), packed.data_ptr(), b.data_ptr(), y.data_ptr(),
             B, ci, H, W, T, co, alpha is not None,
             0.0 if alpha is None else float(alpha), device, stream)
    if err:
        raise RuntimeError(f'small_reflect_conv launch failed: CUDA error '
                           f'{err}')
    small_reflect_conv_cf.launches += 1
    count_kernel_conv(x.shape, co)
    return y


def split_tf32(v):
    """``(hi, lo)`` of a float32 tensor: ``hi = tf32(v)`` rounded to
    nearest, ties away from zero (PTX ``cvt.rna.tf32.f32``: the low 13
    mantissa bits cleared), and ``lo = tf32(v - hi)``. ``hi + lo``
    rebuilds ``v`` to about 2^-22 relative."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(v)
    return hi, rna(v - hi)


def reflect_conv_n_tile(co):
    """Output-channel tile ``csrc/reflect_conv.cu`` runs ``co`` channels
    in: the smallest instantiated tile that holds them, else tiles of
    the largest."""
    return next((n for n in REFLECT_CONV_N_TILES if co <= n),
                REFLECT_CONV_N_TILES[-1])


def pack_weights(weight, n_tile):
    """OI.. weight (co, ci, [3,] 3, 3) -> the kernel's order (co tiles,
    ci chunks, k0, 9 taps, hi/lo, 2 k-halves, n_tile, 4): K-major TF32
    halves, zero-padded to whole tiles and chunks of
    ``REFLECT_CONV_K_STEP`` channels."""
    co, ci = weight.shape[:2]
    k0 = 3 if weight.ndim == 5 else 1
    n_tiles = -(-co // n_tile)
    chunks = -(-ci // REFLECT_CONV_K_STEP)
    w = F.pad(weight.reshape(co, ci, k0, 9),
              (0, 0, 0, 0, 0, chunks * REFLECT_CONV_K_STEP - ci,
               0, n_tiles * n_tile - co))
    w = torch.stack(split_tf32(w)).view(
        2, n_tiles, n_tile, chunks, 2, REFLECT_CONV_K_STEP // 2, k0, 9)
    return w.permute(1, 3, 6, 7, 0, 4, 2, 5).contiguous()


def reflect_conv_check(x, weight, bias):
    """Raise where ``reflect_conv_cf`` refuses its arguments; returns
    True when the kernel should launch (a CUDA tensor), False for the
    plain version (a CPU tensor)."""
    n_spatial = x.ndim - 2
    if n_spatial not in (2, 3):
        raise ValueError(f'reflect_conv: bad input rank {x.ndim}')
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, bias)):
        raise NotImplementedError(
            'reflect_conv is forward-only: the JAX package gives its '
            'kernel no backward and training never routes to it (ROADMAP '
            'queue 2 item 2). Run under torch.inference_mode() or '
            'torch.no_grad().')
    if x.is_cuda and x.dtype != torch.float32:
        raise ValueError(f'{REFLECT_CONV_FP32_ONLY}; got {x.dtype}')
    return _check_args('reflect_conv', x, weight, bias, n_spatial)


def reflect_conv_cf(x, weight, bias, alpha=None):
    """Reflect-pad-1 + k3/s1 conv + bias (+LeakyReLU), 2D or 3D.
    x: (n, ci, *spatial) float32; weight: (co, ci, 3, 3[, 3]);
    bias: (co,). Returns (n, co, *spatial)."""
    if not reflect_conv_check(x, weight, bias):
        return reflect_conv_reference(x, weight, bias, alpha)
    co = weight.shape[0]
    n_tile = reflect_conv_n_tile(co)
    return reflect_conv_packed(x, pack_weights(weight, n_tile), bias, co,
                               n_tile, alpha)


reflect_conv_cf.launches = 0
#: the same launches split by spatial rank (2D or 3D input)
reflect_conv_cf.launches_by_rank = {2: 0, 3: 0}


def reflect_conv_packed(x, packed, bias, co, n_tile, alpha=None):
    """The launch of ``reflect_conv_cf`` alone, on a CUDA input it has
    checked and weights laid out by ``pack_weights(weight, n_tile)``."""
    fn = _c_function('reflect_conv', 'reflect_conv_tf32x3')
    x, b, device, stream = _launch_args(x, bias)
    n_spatial = x.ndim - 2
    spatial = tuple(x.shape[2:])
    s0, s1, s2 = (1,) * (3 - n_spatial) + spatial
    y = torch.empty((x.shape[0], co, *spatial), device=x.device,
                    dtype=x.dtype)
    err = fn(x.data_ptr(), packed.data_ptr(), b.data_ptr(), y.data_ptr(),
             n_spatial, x.shape[0], x.shape[1], co, s0, s1, s2, n_tile,
             alpha is not None, 0.0 if alpha is None else float(alpha),
             device, stream)
    if err:
        raise RuntimeError(f'reflect_conv launch failed: CUDA error {err}')
    reflect_conv_cf.launches += 1
    reflect_conv_cf.launches_by_rank[n_spatial] += 1
    count_kernel_conv(x.shape, co)
    return y


def _to_cf(x, kernel):
    """Channels-last input and DHWIO/HWIO kernel -> channels-first input
    and OIDHW/OIHW weight."""
    n = kernel.ndim - 2
    return (x.permute(0, x.ndim - 1, *range(1, x.ndim - 1)),
            kernel.permute(n + 1, n, *range(n)))


def _to_cl(y):
    return y.permute(0, *range(2, y.ndim), 1)


def small_reflect_conv(x, kernel, bias, alpha=None):
    """JAX-signature form: x (B, H, W, T, CI), kernel (3, 3, 3, CI, CO)
    -> (B, H, W, T, CO)."""
    xc, w = _to_cf(x, kernel)
    return _to_cl(small_reflect_conv_cf(xc, w, bias, alpha))


def reflect_conv(x, kernel, bias, alpha=None):
    """JAX-signature form: x (n, s1, s2[, t], ci), kernel
    (3, 3[, 3], ci, co) -> (n, s1, s2[, t], co)."""
    xc, w = _to_cf(x, kernel)
    return _to_cl(reflect_conv_cf(xc, w, bias, alpha))
