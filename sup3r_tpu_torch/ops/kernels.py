"""The port's hand-written Hopper kernels (``csrc/``, each source file
carrying its bound and design), their plain PyTorch versions, the rules
that route a fused reflect-conv block to them, the cache of their packed
weights and the backward the fused blocks share.

- ``small_reflect_conv_cf`` (``csrc/small_reflect_conv.cu``) replaces
  ``sup3r_tpu/ops/pallas_kernels.py::_small_conv_core`` (reached through
  ``small_reflect_conv``): a 1-cell reflect pad, a k3 3D conv, the bias
  and an optional LeakyReLU for tiny channel counts (the flagship's HR
  8 -> 2 tail), bound by its bytes and fp32 operations alike (~0.07 ms
  there on an H100 SXM). Differentiable, as the JAX package's is
  (``SmallReflectConv``); its wrapper lays out the weights per launch
  (``small_conv_pack_weights``).
- ``reflect_conv_cf`` (``csrc/reflect_conv.cu``) replaces
  ``sup3r_tpu/ops/pallas_kernels.py::reflect_conv``: the same function
  in 2D and 3D, an implicit GEMM on the tensor cores (``wgmma``) in
  3xTF32. Each operand splits into a TF32 ``hi`` and ``lo``
  (``split_tf32``); lo*hi + hi*lo + hi*hi keeps fp32-class accuracy (the
  dropped lo*lo is ~2^-22 relative), not bit equality with cuDNN. Bound
  by operations: ~0.82 ms per flagship body conv against ~2.0 ms for
  fp32 on the CUDA cores. It has no backward (nor has the JAX
  package's) and takes float32 only; a fused block keeps its weights'
  packing (``pack_weights``) in a ``PackedWeights``.
- ``reflect_conv_wgrad`` (``csrc/reflect_conv_wgrad.cu``) is a fused 3D
  block's weight gradient in training: dy packed to TF32 halves, a
  split-K 3xTF32 GEMM whose reflect halo is index math, an ordered
  reduction. It replaces no Pallas kernel: the JAX package leaves the
  weight gradient to XLA.

The route of a fused block (``models/fuse.py``: ``FusedReflectConv.route``
names it from these rules and the block's flags, ``forward`` runs it):

- 'small': a 3D float32 block with ``ci * co <= SMALL_KERNEL_MAX_CI_CO``
  (``small_kernel_wins``) takes the small kernel while the block's
  ``small_channel_kernel`` is on (the default), in training too.
- 'body': any other block on the card run without gradients takes
  ``reflect_conv`` where ``body_kernel_wins`` (float32, at the shapes
  where the kernel was timed faster than cuDNN's fp32 conv), or with the
  block's ``use_pallas`` (``Sup3rGan.inference_pallas``) whatever its
  shape and dtype (``reflect_conv_check`` refuses bf16, as the JAX
  package's Pallas kernel does). The JAX package gated its kernel on
  ``_fits_vmem``, a TPU VMEM rule with no counterpart here, and left it
  opt-in because XLA's conv emitter won on the TPU.
- 'library': otherwise ``ops/conv_ad.py``'s ``reflect_conv_ad`` (reflect
  pad, cuDNN, the activation) or, with the block's ``shard_aligned``,
  its shard-aligned formulation. A CPU tensor takes this route on every
  block: the kernels' plain version.
- Under a spatial mesh (``ctx['spatial']``), on either device, a block of
  s1 rows exchanges boundary rows with its neighbours and runs
  ``reflect_conv_halo`` on cuDNN ('halo'; 'small_halo' for a block the
  small kernel would take), or, where the shard has ``gather_small``,
  the small kernel's blocks go the JAX package's way ('gather_small': XLA
  cannot partition a ``pallas_call``): the block is gathered over the
  axis, the kernel runs on the whole tensor, the rank keeps its rows.
- The weight gradient, in ``reflect_conv_backward`` (the backward of the
  library route and of the small kernel): ``reflect_conv_wgrad`` where
  ``wgrad_kernel_wins`` (float32 3D blocks on the card of at least
  ``WGRAD_KERNEL_MIN_CELLS`` output cells), else cuDNN's. The sharded
  formulations' backwards keep cuDNN.

While a profiler records (``utilities/trace.py``), each block the small
kernel does not take counts ``fuse.body_kernel`` ('body') or
``fuse.body_cudnn`` ('library', 'halo'), each packing ``fuse.body_pack``,
each weight gradient in ``reflect_conv_backward`` ``conv_ad.wgrad_kernel``
or ``conv_ad.wgrad_cudnn``: the names of the modules that first counted
them, which the benchmark reads.

Wrappers take channels-first tensors (``(n, c, *spatial)``, OI..
weights). A CPU tensor takes the plain version
(``reflect_conv_reference``, ``reflect_conv_wgrad_reference``); a CUDA
tensor launches the kernel or raises. Each wrapper's ``launches``
counts its launches (forward launches only for the forward kernels;
``reflect_conv_cf.launches_by_rank`` by spatial rank), and each launch
reports its FLOPs to ``utilities.flops.estimate_flops``, which cannot see
a ``ctypes`` launch. ``small_reflect_conv`` and ``reflect_conv`` keep the
JAX package's channels-last signatures.
"""

import ctypes
import math

import torch
import torch.nn.functional as F

from sup3r_tpu_torch.ops import build
from sup3r_tpu_torch.utilities import trace
from sup3r_tpu_torch.utilities.flops import count_kernel_conv

#: output channels ``small_reflect_conv_cf`` takes
SMALL_CONV_MAX_CO = 32
#: largest ci * co it takes (the route's rule is
#: ``SMALL_KERNEL_MAX_CI_CO``)
SMALL_CONV_MAX_CI_CO = 455
#: output channels per block of ``csrc/small_reflect_conv.cu``; a larger
#: co runs in groups of this many
SMALL_CONV_CO_TILE = 4
#: output-channel tiles ``csrc/reflect_conv.cu`` is instantiated for
REFLECT_CONV_N_TILES = (32, 64, 72, 128)
#: input channels per K-step of ``csrc/reflect_conv.cu`` (tf32 wgmma k8)
REFLECT_CONV_K_STEP = 8

#: the largest ci * co of a block the route gives the small kernel
SMALL_KERNEL_MAX_CI_CO = 32
#: the widest block input ``reflect_conv`` was timed on; its K loop runs
#: serially in each thread block, and at 512 and 1024 input channels it
#: lost to cuDNN
BODY_KERNEL_MAX_CI = 256
#: output cells (batch times spatial volume) from which the kernel's
#: thread blocks hide its serial K-steps
BODY_KERNEL_MIN_CELLS = 4096
#: K-steps the kernel runs within cuDNN's ~0.05 ms floor (three
#: launches: pad, conv, LeakyReLU) at any number of output cells
BODY_KERNEL_MAX_SHORT_STEPS = 9
#: the kernel's grid takes the batch as its z dimension
BODY_KERNEL_MAX_BATCH = 65535
#: output cells (batch times volume), the weight gradient's K sum, from
#: which the hand-written ``reflect_conv_wgrad`` takes a block's weight
#: gradient (``wgrad_kernel_wins``)
WGRAD_KERNEL_MIN_CELLS = 16384

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: each C entry point's arguments, by its name
_SIGNATURES = {
    'small_reflect_conv_f32': [_PTR] * 4 + [_INT] * 7 + [_FLOAT, _INT, _PTR],
    'reflect_conv_tf32x3': [_PTR] * 4 + [_INT] * 9 + [_FLOAT, _INT, _PTR],
    'reflect_conv_wgrad_scratch': [_INT] * 7 + [_PTR],
    'reflect_conv_wgrad_tf32x3': [_PTR] * 5 + [_INT] * 7 + [_PTR],
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


def _on_card(name, x, *others):
    """True when the kernel should launch (``x`` on a CUDA device), False
    for the plain version (``x`` on the CPU); raises for another device,
    for a tensor that is not float32 on ``x``'s device, or for a spatial
    dim below 2."""
    if x.device.type == 'cpu':
        return False
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {x.device}')
    for t in (x, *others):
        if t.device != x.device or t.dtype != torch.float32:
            raise ValueError(
                f'{name}: the CUDA kernel takes float32 tensors on one '
                f'device; got {t.dtype} on {t.device} beside x on '
                f'{x.device}')
    if min(x.shape[2:]) < 2:
        raise ValueError(f'{name}: reflect padding needs every spatial dim '
                         f'>= 2, got {tuple(x.shape[2:])}')
    return True


def _check_args(name, x, weight, bias, n_spatial):
    """Common validation of a forward kernel's arguments; returns
    ``_on_card``'s answer."""
    if x.ndim != 2 + n_spatial:
        raise ValueError(f'{name}: expected a {2 + n_spatial}D input, got '
                         f'shape {tuple(x.shape)}')
    co, ci = weight.shape[:2]
    if (tuple(weight.shape) != (co, x.shape[1]) + (3,) * n_spatial
            or tuple(bias.shape) != (co,)):
        raise ValueError(
            f'{name}: weight {tuple(weight.shape)} / bias '
            f'{tuple(bias.shape)} do not fit input {tuple(x.shape)}')
    return _on_card(name, x, weight, bias)


def _launch_args(x, bias):
    """Contiguous input and bias, and the device index and stream to
    launch on."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return x.contiguous(), bias.contiguous(), x.device.index, stream


def small_kernel_wins(x, co):
    """Whether a fused block on input ``x`` (channels-first) to ``co``
    output channels is the small kernel's: a 3D float32 input with ``ci
    * co <= SMALL_KERNEL_MAX_CI_CO``, on either device (on the CPU the
    block runs the plain version). Reads ``x.shape`` and ``x.dtype``
    only."""
    return (len(x.shape) == 5 and x.dtype == torch.float32
            and x.shape[1] * co <= SMALL_KERNEL_MAX_CI_CO)


def body_kernel_wins(x):
    """Whether ``reflect_conv`` was timed faster than the library route
    (reflect pad, cuDNN's fp32 conv, LeakyReLU) for a block on input
    ``x`` (n, ci, *spatial) on an H100 (PERF.md, kernel table): a float32
    tensor on the card, every spatial dim >= 2 (the reflect pad's), of a
    shape where the kernel won. Each thread block of the kernel runs
    ``ceil(ci / 8)`` K-steps per plane of taps (3 planes in 3D, 1 in 2D)
    one after another, so a block with few output cells and many steps
    is quicker on cuDNN, as (2, 64, 9, 11, 13) and (8, 64, 4, 4, 4) were;
    every timed shape that this sends to the kernel was faster there.
    Reads ``x.shape``, ``x.dtype`` and ``x.is_cuda`` only."""
    n, ci, *spatial = x.shape
    steps = -(-ci // REFLECT_CONV_K_STEP) * (3 if len(spatial) == 3 else 1)
    return (x.is_cuda and x.dtype == torch.float32 and min(spatial) >= 2
            and n <= BODY_KERNEL_MAX_BATCH and ci <= BODY_KERNEL_MAX_CI
            and (steps <= BODY_KERNEL_MAX_SHORT_STEPS
                 or n * math.prod(spatial) >= BODY_KERNEL_MIN_CELLS))


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
    (``ops/conv_ad.py``'s ``ReflectConvShardAligned``,
    ``ReflectConvHalo``) never ask."""
    n, _, *spatial = x.shape
    return (x.is_cuda and x.dtype == dy.dtype == torch.float32
            and len(spatial) == 3 and min(spatial) >= 2
            and n * math.prod(spatial) >= WGRAD_KERNEL_MIN_CELLS)


def _conv(n_spatial):
    return (F.conv1d, F.conv2d, F.conv3d)[n_spatial - 1]


def _conv_weight_grad(n_spatial):
    grad = torch.nn.grad
    return (grad.conv1d_weight, grad.conv2d_weight,
            grad.conv3d_weight)[n_spatial - 1]


def reflect_conv_reference(x, weight, bias, alpha=None):
    """Plain PyTorch version of the forward kernels: ``F.pad(mode=
    'reflect')``, ``F.conv3d`` / ``F.conv2d`` with the bias,
    ``F.leaky_relu`` (the library route's forward)."""
    n_spatial = x.ndim - 2
    xp = F.pad(x, (1, 1) * n_spatial, mode='reflect')
    pre = _conv(n_spatial)(xp, weight, bias)
    return pre if alpha is None else F.leaky_relu(pre, alpha)


def reflect_conv_wgrad_reference(x, dy):
    """The weight gradient of a reflect-pad-1 k3 conv (2D or 3D) at
    ``dy``: the library's (cuDNN's on the card) native weight gradient on
    a reflect-padded copy of ``x``. The plain version of
    ``reflect_conv_wgrad``."""
    n_spatial = x.ndim - 2
    xp = F.pad(x, (1, 1) * n_spatial, mode='reflect')
    shape = (dy.shape[1], x.shape[1]) + (3,) * n_spatial
    return _conv_weight_grad(n_spatial)(xp, shape, dy)


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


def reflect_conv_backward(dy, x, weight, n_spatial, alpha, pre,
                          needs=(True, True, True)):
    """(dx, dweight, dbias) of reflect-pad-1 -> k3 conv -> +bias ->
    LeakyReLU(alpha) at ``dy``, the backward of the library route
    (``ReflectConvAD``) and of the small kernel (``SmallReflectConv``),
    in ``dy``'s dtype:

    - the LeakyReLU mask ``where(pre >= 0, 1, alpha)`` (``jax.nn.
      leaky_relu``'s gradient at exactly 0 is 1); ``pre`` is the
      pre-activation, or for ``alpha > 0`` the output;
    - ``dbias``, the sum of the masked gradient;
    - dgrad as ONE conv of the gradient with the spatially flipped,
      IO-swapped kernel and full (2, 2) padding, which gives the gradient
      of the padded input, then ``_fold_reflect_halos``;
    - wgrad on ``reflect_conv_wgrad`` where ``wgrad_kernel_wins``, else
      ``reflect_conv_wgrad_reference``, counted ``conv_ad.wgrad_kernel``
      / ``conv_ad.wgrad_cudnn`` by the route it ran.

    ``needs`` skips the gradients nobody asked for."""
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
            'reflect_conv is forward-only: the kernel has no backward (the '
            'JAX package gives its Pallas kernel none either), so training '
            'routes around it, to the library route. Run it under '
            'torch.inference_mode() or torch.no_grad().')
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


class PackedWeights:
    """The cache of one fused block's ``reflect_conv`` weights: the
    packing is made again only when the block's parameter, its version
    (training updates it in place), its storage or the current stream
    changes, and at every call for a parameter made under
    ``torch.inference_mode``, which keeps no version. Each packing counts
    ``fuse.body_pack`` while a profiler records."""

    def __init__(self):
        # (param, (its version, its storage, the stream), n_tile, packed
        # weights) of the last packing
        self._last = None

    def get(self, param, weight):
        """(n_tile, ``pack_weights(weight, n_tile)``) of ``weight``, the
        block's OI.. weight made from its parameter ``param``."""
        stream = (torch.cuda.current_stream(weight.device).cuda_stream
                  if weight.is_cuda else None)
        version = None if param.is_inference() else param._version
        key = (version, param.data_ptr(), stream)
        last = self._last
        if (last is None or last[0] is not param or version is None
                or last[1] != key):
            n_tile = reflect_conv_n_tile(weight.shape[0])
            last = self._last = (param, key, n_tile,
                                 pack_weights(weight, n_tile))
            trace.count('fuse.body_pack')
        return last[2:]

    def reflect_conv(self, x, param, weight, bias, alpha=None):
        """``reflect_conv_cf`` of a block on its cached packing: checked
        (``reflect_conv_check``), then launched."""
        reflect_conv_check(x, weight, bias)
        n_tile, packed = self.get(param, weight)
        return reflect_conv_packed(x, packed, bias, weight.shape[0], n_tile,
                                   alpha)


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
    if not _on_card('reflect_conv_wgrad', x, dy):
        return reflect_conv_wgrad_reference(x, dy)
    x, dy = x.contiguous(), dy.contiguous()
    n, ci, s0, s1, s2 = x.shape
    co = dy.shape[1]
    device = x.device.index
    sizes = (ctypes.c_longlong * 2)()
    err = _c_function('reflect_conv_wgrad', 'reflect_conv_wgrad_scratch')(
        n, ci, co, s0, s1, s2, device, ctypes.addressof(sizes))
    if err:
        raise RuntimeError(f'reflect_conv_wgrad: no launch plan for x '
                           f'{tuple(x.shape)} -> {co}: CUDA error {err}')
    packed = torch.empty(sizes[0], device=x.device, dtype=x.dtype)
    partial = torch.empty(sizes[1], device=x.device, dtype=x.dtype)
    dw = torch.empty((co, ci, 3, 3, 3), device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _c_function('reflect_conv_wgrad', 'reflect_conv_wgrad_tf32x3')(
        x.data_ptr(), dy.data_ptr(), packed.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), n, ci, co, s0, s1, s2, device, stream)
    if err:
        raise RuntimeError(f'reflect_conv_wgrad launch failed: CUDA error '
                           f'{err}')
    reflect_conv_wgrad.launches += 1
    count_kernel_conv(x.shape, co)
    return dw


reflect_conv_wgrad.launches = 0


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
