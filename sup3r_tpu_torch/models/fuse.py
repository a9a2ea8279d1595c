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
  * ``use_pallas`` (``Sup3rGan.inference_pallas``): EVERY other fused
    block launches the hand-written ``reflect_conv`` kernel, but only
    while gradients are off: that kernel has no backward. The JAX
    package also gated this on ``_fits_vmem``, a TPU VMEM-residency
    rule with no counterpart here;
  * otherwise the block runs ``reflect_conv_ad``: ``F.pad`` + cuDNN,
    with the custom backward.
On a CPU tensor every block runs ``reflect_conv_ad``, the kernels'
plain version. A block of s1 rows under a spatial mesh
(``ctx['spatial']``, a ``parallel.mesh.SpatialShard``) comes first, on
either device. By default it exchanges its boundary rows with its
neighbours and runs ``reflect_conv_halo`` on cuDNN, differentiably (the
halo rows' gradients go back to their owners). A shard with
``gather_small`` (the train step below the shard-aligned gate,
``Sup3rGan.train_shard_aligned``) sends the blocks the small kernel
takes the JAX package's way instead: XLA cannot partition a
``pallas_call``, so it gathers the kernel's input over the axis; here
the block is gathered over the axis (``SpatialShard.gather``, whose
backward sends each row's gradient back to its owner), the kernel runs
on the whole tensor and the rank keeps its rows. At and above the gate
the JAX package's shard-aligned route bypasses Pallas, and so does the
port's halo route; sharded serving (``Sup3rGan.generate(mesh=)``) keeps
the halo route at every width. ``shard_aligned`` (the JAX package's
formulation for its SPMD partitioner) takes the place of
``reflect_conv_ad`` only: on the card the kernels keep the blocks they
take, and on a block the port's one-row halo exchange is the same in
either formulation. A block runs in its input's dtype: its weight and
bias are cast to it (differentiably).
A bf16 block is never the small kernel's (it takes float32 only, as the
JAX package's does), so a bf16 tail runs ``reflect_conv_ad`` on cuDNN;
``reflect_conv`` refuses bf16, as the JAX package's Pallas kernel does.

``fuse_subpixel_tail`` (fast mode, ``Sup3rGan.inference_subpixel_tail``)
folds the generator's ``expansion -> tail conv`` ending into one
``SubpixelTailConv`` at the pre-expansion resolution
(``ops/subpixel.py``).
"""

import logging

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
from sup3r_tpu_torch.ops.kernels import reflect_conv_cf, small_reflect_conv_cf
from sup3r_tpu_torch.ops.subpixel import subpixel_tail_conv

logger = logging.getLogger(__name__)


class FusedReflectConv(Layer):
    """Fused reflect-pad + k3 conv + crop + activation block.

    The shipped generators wrap every conv in FlexiblePadding(3,
    REFLECT) -> Conv(valid) -> Cropping(2), which computes a 2-cell
    halo ring that is immediately cropped away. This block is the
    algebraic simplification (reflect-pad-1 + valid conv). It holds
    the conv layer, and reads its weight (OI.. layout, as
    ``fused_weight``) and bias at each call."""

    #: route every fused block the small kernel does not take to the
    #: hand-written ``reflect_conv`` kernel (set from
    #: ``Sup3rGan.inference_pallas``)
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

    def forward(self, x, ctx):
        on_cuda = x.is_cuda
        weight = self.conv.fused_weight(x.dtype)
        bias = self.bias.to(x.dtype)
        small = self.small_channel_kernel and self._small_ok(x, weight)
        shard = ctx.get('spatial')
        if shard is not None and not (small and shard.gather_small):
            return reflect_conv_halo(x, weight, bias, self.n_spatial,
                                     self.alpha, *shard.halo(x))
        if shard is not None:
            # the whole tensor through the kernel; this rank's rows out
            start, count = shard.block(ctx['s1'])
            y = small_reflect_conv_cf(shard.gather(x, ctx['s1']), weight,
                                      bias, self.alpha)
            return y.narrow(2, start, count)
        if small and on_cuda:
            return small_reflect_conv_cf(x, weight, bias, self.alpha)
        if self.use_pallas and on_cuda and not torch.is_grad_enabled():
            return reflect_conv_cf(x, weight, bias, self.alpha)
        if self.shard_aligned:
            return reflect_conv_shard_aligned(x, weight, bias,
                                              self.n_spatial, self.alpha)
        return reflect_conv_ad(x, weight, bias, self.n_spatial, self.alpha)


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
