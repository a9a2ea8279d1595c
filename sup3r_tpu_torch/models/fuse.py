"""Network optimization for inference and training: rewrite
``FlexiblePadding(reflect) -> Conv(k3,s1) -> Cropping (-> LeakyReLU)``
sequences into single fused reflect-pad-1 convolutions (the port of
``sup3r_tpu/models/fuse.py``).

Shape algebra (why this is exact): with inner reflect pad p and crop c,
the retained output pixels only ever read a 1-pixel reflect halo:
  * Conv(k3, valid):  centered window iff p = c + 1  (configs: p3/c2)
  * ConvT(k3, valid): centered window of the full-padding correlation
    iff c = p + 1 (configs: p3/c4)
so both reduce to a k3/s1 reflect-boundary conv. Inline 'relu'
activations fold in as LeakyReLU(alpha=0).

A fused block holds its conv layer, so it reads the conv's current
parameters at every call and gradients land on them: the generator's
own ``nn.Parameter``s. ``Sup3rGan`` fuses the generator for training too
(``train_fuse``): the same rewrite saves the halo ring's work in the
forward and the backward.

Routing of a fused block (``FusedReflectConv.forward``), on a CUDA
tensor:
  * ``small_channel_kernel`` (on by default): 3D, fp32, ``ci * co <=
    32`` blocks (the flagship's HR 8 -> 2 tail) launch the hand-written
    ``small_reflect_conv`` kernel;
  * every other fp32 block run without gradients launches the
    hand-written ``reflect_conv`` kernel where it was timed faster than
    cuDNN's fp32 conv on an H100 (``body_kernel_wins``: every block of
    the shipped generators at their serving shapes), on weights it
    packs once per weight version (``_packed``). ``use_pallas``
    (``Sup3rGan.inference_pallas``) sends EVERY such block to it,
    whatever its shape. That kernel has no backward, so a training step
    never takes it; it takes float32 only, so a bf16 body stays on
    cuDNN. The JAX package gated its Pallas kernel on ``_fits_vmem``, a
    TPU VMEM-residency rule with no counterpart here, and left it
    opt-in because XLA's conv emitter won on the TPU;
  * otherwise the block runs ``reflect_conv_ad``: ``F.pad`` + cuDNN,
    with the custom backward.
On a CPU tensor every block runs ``reflect_conv_ad``, the kernels'
plain version. A block of s1 rows under a spatial mesh
(``ctx['spatial']``, a ``parallel.mesh.SpatialShard``) comes first, on
either device. By default it exchanges its boundary rows with its
neighbours and runs ``reflect_conv_halo`` on cuDNN, differentiably (the
halo rows' gradients go back to their owners). A shard with
``gather_small`` (the train step below the shard-aligned gate,
``Sup3rGan.train_shard_aligned``, and sharded serving while
``Sup3rGan.inference_shard_aligned`` is off) sends the blocks the small
kernel takes the JAX package's way instead: XLA cannot partition a
``pallas_call``, so it gathers the kernel's input over the axis; here
the block is gathered over the axis (``SpatialShard.gather``, whose
backward sends each row's gradient back to its owner), the kernel runs
on the whole tensor and the rank keeps its rows. At and above the gate
the JAX package's shard-aligned route bypasses Pallas, and so does the
port's halo route. ``shard_aligned`` (the JAX package's
formulation for its SPMD partitioner) takes the place of
``reflect_conv_ad`` only: on the card the kernels keep the blocks they
take, and on a block the port's one-row halo exchange is the same in
either formulation. A block runs in its input's dtype: its weight and
bias are cast to it (differentiably).
A bf16 block is never the small kernel's (it takes float32 only, as the
JAX package's does), so a bf16 tail runs ``reflect_conv_ad`` on cuDNN;
``reflect_conv`` refuses bf16, as the JAX package's Pallas kernel does.
While a profiler records, each block the small kernel does not take
counts ``fuse.body_kernel`` or ``fuse.body_cudnn`` by the route it ran
(``utilities/trace.py``; ``body_cudnn`` is the library route on either
device), and each packing of a block's weights ``fuse.body_pack``.

``fuse_subpixel_tail`` (fast mode, ``Sup3rGan.inference_subpixel_tail``)
folds the generator's ``expansion -> tail conv`` ending into one
``SubpixelTailConv`` at the pre-expansion resolution
(``ops/subpixel.py``).
"""

import logging
import math

import torch

from sup3r_tpu_torch.models.layers import (
    ACTIVATIONS,
    Activation,
    Conv2D,
    Conv2DTranspose,
    Conv3D,
    Conv3DTranspose,
    Cropping2D,
    Cropping3D,
    FlexiblePadding,
    Layer,
    LeakyReLU,
    SpatialExpansion,
    SpatioTemporalExpansion,
)
from sup3r_tpu_torch.ops.conv_ad import (
    reflect_conv_ad,
    reflect_conv_halo,
    reflect_conv_shard_aligned,
)
from sup3r_tpu_torch.ops.kernels import (
    REFLECT_CONV_K_STEP,
    pack_weights,
    reflect_conv_check,
    reflect_conv_n_tile,
    reflect_conv_packed,
    small_reflect_conv_cf,
)
from sup3r_tpu_torch.ops.subpixel import subpixel_tail_conv
from sup3r_tpu_torch.utilities import trace

logger = logging.getLogger(__name__)

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


def body_kernel_wins(x_shape):
    """Whether ``reflect_conv`` was timed faster than the library route
    (reflect pad, cuDNN's fp32 conv, LeakyReLU) for a block on an input
    of ``x_shape`` (n, ci, *spatial) on an H100 (PERF.md, kernel
    table). Each thread block of the kernel runs ``ceil(ci / 8)`` K-steps
    per plane of taps (3 planes in 3D, 1 in 2D) one after another, so a
    block with few output cells and many steps is quicker on cuDNN, as
    (2, 64, 9, 11, 13) and (8, 64, 4, 4, 4) were; every timed shape that
    this sends to the kernel was faster there."""
    n, ci, *spatial = x_shape
    steps = -(-ci // REFLECT_CONV_K_STEP) * (3 if len(spatial) == 3 else 1)
    return n <= BODY_KERNEL_MAX_BATCH and ci <= BODY_KERNEL_MAX_CI and (
        steps <= BODY_KERNEL_MAX_SHORT_STEPS
        or n * math.prod(spatial) >= BODY_KERNEL_MIN_CELLS)


class FusedReflectConv(Layer):
    """Fused reflect-pad + k3 conv + crop + activation block.

    The shipped generators wrap every conv in FlexiblePadding(3,
    REFLECT) -> Conv(valid) -> Cropping(2), which computes a 2-cell
    halo ring that is immediately cropped away. This block is the
    algebraic simplification (reflect-pad-1 + valid conv). It holds
    the conv layer, and reads its weight (OI.. layout, as
    ``fused_weight``) and bias at each call."""

    #: route every fused block the small kernel does not take to the
    #: hand-written ``reflect_conv`` kernel, whatever its shape (set from
    #: ``Sup3rGan.inference_pallas``); off, ``_body_ok`` decides
    use_pallas = False

    #: route tiny-channel 3D convs (ci*co <= 32, e.g. the flagship
    #: generator's final 8->2 conv at HR resolution) to the
    #: ``small_reflect_conv`` kernel
    small_channel_kernel = True

    #: the JAX package's shard-aligned s1 formulation (set from
    #: ``Sup3rGan.inference_shard_aligned``): s1 zero-padded inside the
    #: conv and its boundary rows corrected, on cuDNN, in place of
    #: ``reflect_conv_ad`` (not of the kernels, nor of the sharded
    #: route); equal to the default route up to fp32 reassociation
    shard_aligned = False

    sharded_form = True

    def __init__(self, n_spatial, conv, alpha=None):
        super().__init__()
        self.n_spatial = n_spatial
        self.alpha = alpha
        self.conv = conv
        # (param, (its version, its storage, the stream), n_tile, packed
        # weights) of the last packing
        self._pack = None

    @property
    def weight(self):
        """The conv's OI.. correlation weight (differentiable in the
        conv's own parameter)."""
        return self.conv.fused_weight()

    @property
    def bias(self):
        return self.conv.bias

    def out_shape(self, in_shape):
        raise NotImplementedError(
            'FusedReflectConv is created by fuse_network with existing '
            'params; shape inference happens pre-fusion')

    def _small_ok(self, x, weight):
        co, ci = weight.shape[:2]
        return (self.n_spatial == 3 and x.ndim == 5
                and x.dtype == torch.float32 and ci * co <= 32)

    def _body_ok(self, x, weight, ctx):
        """Whether the block runs on ``reflect_conv`` by default: an fp32
        CUDA input without gradients, unsharded, that the small kernel
        does not take, at a shape where the kernel was timed faster
        (``body_kernel_wins``)."""
        return (x.is_cuda and x.dtype == torch.float32
                and not torch.is_grad_enabled()
                and ctx.get('spatial') is None
                and not (self.small_channel_kernel
                         and self._small_ok(x, weight))
                and min(x.shape[2:]) >= 2
                and body_kernel_wins(tuple(x.shape)))

    def _packed(self, weight):
        """(n_tile, ``pack_weights(weight, n_tile)``), packed again only
        when the conv's parameter, its version (training updates it in
        place), its storage or the current stream changes; at every call
        for a parameter made under ``torch.inference_mode``, which keeps
        no version."""
        param = self.conv.weight
        stream = (torch.cuda.current_stream(weight.device).cuda_stream
                  if weight.is_cuda else None)
        version = None if param.is_inference() else param._version
        key = (version, param.data_ptr(), stream)
        pack = self._pack
        if (pack is None or pack[0] is not param or version is None
                or pack[1] != key):
            n_tile = reflect_conv_n_tile(weight.shape[0])
            pack = self._pack = (param, key, n_tile,
                                 pack_weights(weight, n_tile))
            trace.count('fuse.body_pack')
        return pack[2:]

    def _library(self, x, weight, bias):
        if self.shard_aligned:
            return reflect_conv_shard_aligned(x, weight, bias,
                                              self.n_spatial, self.alpha)
        return reflect_conv_ad(x, weight, bias, self.n_spatial, self.alpha)

    def forward(self, x, ctx):
        weight = self.conv.fused_weight(x.dtype)
        bias = self.bias.to(x.dtype)
        small = self.small_channel_kernel and self._small_ok(x, weight)
        shard = ctx.get('spatial')
        if shard is not None and not (small and shard.gather_small):
            if not small:
                trace.count('fuse.body_cudnn')
            return reflect_conv_halo(x, weight, bias, self.n_spatial,
                                     self.alpha, *shard.halo(x))
        if shard is not None:
            # the whole tensor through the kernel; this rank's rows out
            start, count = shard.block(ctx['s1'])
            y = small_reflect_conv_cf(shard.gather(x, ctx['s1']), weight,
                                      bias, self.alpha)
            return y.narrow(2, start, count)
        if small:
            if x.is_cuda:
                return small_reflect_conv_cf(x, weight, bias, self.alpha)
            return self._library(x, weight, bias)
        if self._body_ok(x, weight, ctx) or (
                self.use_pallas and x.is_cuda
                and not torch.is_grad_enabled()):
            trace.count('fuse.body_kernel')
            reflect_conv_check(x, weight, bias)
            n_tile, packed = self._packed(weight)
            return reflect_conv_packed(x, packed, bias, weight.shape[0],
                                       n_tile, self.alpha)
        trace.count('fuse.body_cudnn')
        return self._library(x, weight, bias)


def _inner_pads(pad_layer):
    """(n_spatial, pad width), or None if not all-equal reflect."""
    if pad_layer.mode != 'reflect':
        return None
    inner = pad_layer.paddings[1:-1]
    widths = {w for pair in inner for w in pair}
    if len(widths) != 1:
        return None
    return len(inner), widths.pop()


def fuse_network(layers):
    """Rewrite fusable sequences; returns the new layer list.

    Non-matching layers pass through untouched (the same module
    objects), so this is safe to run on any network."""
    new_layers = []
    i = 0
    n_fused = 0
    while i < len(layers):
        match = _match_sequence(layers, i)
        if match is None:
            new_layers.append(layers[i])
            i += 1
            continue
        emitted, consumed = match
        new_layers.extend(emitted)
        i += consumed
        n_fused += 1
    if n_fused:
        logger.info('Fused %d reflect-conv blocks', n_fused)
    return new_layers


def _match_sequence(layers, i):
    """Try to match a fusable sequence starting at layer i; returns
    (emitted layers, number consumed) or None."""
    if not isinstance(layers[i], FlexiblePadding):
        return None
    pads = _inner_pads(layers[i])
    if pads is None:
        return None
    n_spatial, p = pads
    if i + 2 >= len(layers):
        return None
    conv = layers[i + 1]
    crop = layers[i + 2]
    conv_types = {2: (Conv2D, Conv2DTranspose),
                  3: (Conv3D, Conv3DTranspose)}.get(n_spatial)
    crop_type = {2: Cropping2D, 3: Cropping3D}.get(n_spatial)
    if conv_types is None or not isinstance(conv, conv_types) or (
            not isinstance(crop, crop_type)):
        return None
    if conv.kernel_size != (3,) * n_spatial or conv.strides != (
            1,) * n_spatial or conv.padding != 'VALID':
        return None
    crops = {w for pair in crop.crops for w in pair}
    if len(crops) != 1:
        return None
    c = crops.pop()
    if conv.transpose and c != p + 1:
        return None
    if not conv.transpose and c != p - 1:
        return None

    # activation: inline on the conv, or a following LeakyReLU /
    # Activation('relu') layer
    alpha = None
    consumed = 3
    trailing = []
    if conv._act is not None:
        if conv._act is not ACTIVATIONS['relu']:
            return None
        alpha = 0.0
    elif i + 3 < len(layers):
        nxt = layers[i + 3]
        alpha = _activation_alpha(nxt)
        if alpha is not None:
            consumed = 4
        elif _movement_only_expansion(nxt) and i + 4 < len(layers):
            # conv -> EXPANSION -> activation: pixel shuffles / frame
            # repeats only MOVE or DUPLICATE values, so the elementwise
            # activation commutes exactly across them and folds into
            # the fused conv's epilogue
            alpha = _activation_alpha(layers[i + 4])
            if alpha is not None:
                consumed = 5
                trailing = [nxt]

    fused = FusedReflectConv(n_spatial, conv, alpha=alpha)
    return [fused, *trailing], consumed


def _activation_alpha(layer):
    """LeakyReLU slope of an activation layer (0 for ReLU), else None."""
    if isinstance(layer, LeakyReLU):
        return layer.alpha
    if isinstance(layer, Activation) and layer.name == 'relu':
        return 0.0
    return None


def _movement_only_expansion(layer):
    """Whether ``layer`` only MOVES or DUPLICATES values (pixel
    shuffle / frame repeat) — the condition under which an elementwise
    activation commutes exactly across it. Linear temporal
    interpolation averages values and does NOT qualify."""
    if isinstance(layer, SpatialExpansion):
        return True
    return (isinstance(layer, SpatioTemporalExpansion)
            and (layer.temporal_mult == 1
                 or layer.temporal_method in ('nearest', 'depth_to_time')))


class SubpixelTailConv(Layer):
    """Fast mode's tail: ``SpatioTemporalExpansion(spatial m) ->
    (LeakyReLU) -> FusedReflectConv`` folded to the pre-expansion
    resolution (``ops/subpixel.py``). It holds the fused tail block and
    reads its conv's weight at each call. The conv runs in the input's
    dtype: bf16 in fast mode, float32 (TF32 off) in the 'custom' mode
    with the tail on and ``inference_dtype`` None. On a block of s1 rows
    under a spatial mesh it exchanges one boundary cell with each
    neighbour first."""

    sharded_form = True

    def __init__(self, m, tail, alpha_prev=None):
        super().__init__()
        self.m = m
        self.tail = tail
        self.alpha_prev = alpha_prev
        self.alpha = tail.alpha

    def out_shape(self, in_shape):
        raise NotImplementedError(
            'SubpixelTailConv is created by fuse_subpixel_tail with '
            'existing params')

    def forward(self, x, ctx):
        shard = ctx.get('spatial')
        if shard is not None:
            ctx['s1'] *= self.m
        return subpixel_tail_conv(
            x, self.tail.conv.fused_weight(x.dtype), self.tail.bias, self.m,
            alpha_prev=self.alpha_prev, alpha=self.alpha,
            halo=(None, None) if shard is None else shard.halo(x))


def fuse_subpixel_tail(layers):
    """Rewrite an ``[SpatioTemporalExpansion (spatial only), LeakyReLU,
    FusedReflectConv]`` ending, or ``[SpatioTemporalExpansion,
    FusedReflectConv]`` when ``fuse_network`` already folded the
    activation into the previous conv, into one ``SubpixelTailConv``.
    Returns the new layer list; a list without the pattern passes
    through."""
    new_layers = list(layers)
    for i in range(len(new_layers) - 1):
        exp = new_layers[i]
        if not (isinstance(exp, SpatioTemporalExpansion)
                and exp.spatial_mult > 1 and exp.temporal_mult == 1):
            continue
        act = new_layers[i + 1]
        if isinstance(act, LeakyReLU) and i + 2 < len(new_layers):
            alpha_prev, tail_idx = act.alpha, i + 2
        else:
            alpha_prev, tail_idx = None, i + 1
        tail = new_layers[tail_idx]
        if not (isinstance(tail, FusedReflectConv) and tail.n_spatial == 3
                and tail.conv.kernel_size == (3, 3, 3)):
            continue
        fused = SubpixelTailConv(exp.spatial_mult, tail,
                                 alpha_prev=alpha_prev)
        new_layers[i:tail_idx + 1] = [fused]
        logger.info('Fused subpixel tail (m=%d) for inference', fused.m)
        break
    return new_layers
