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

A fused block names its route with ``FusedReflectConv.route`` and runs
it in ``forward``: the hand-written kernels, the library route
(``ops/conv_ad.py``) or, on a block of s1 rows under a spatial mesh, the
halo exchange or the small kernel's gather. The rules that choose, the
kernels' packed-weight cache and the route counters are described once,
in ``ops/kernels.py``. A block runs in its input's dtype: its weight and
bias are cast to it (differentiably).

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
from sup3r_tpu_torch.ops import kernels
from sup3r_tpu_torch.ops.conv_ad import (
    reflect_conv_ad,
    reflect_conv_halo,
    reflect_conv_shard_aligned,
)
from sup3r_tpu_torch.ops.kernels import small_reflect_conv_cf
from sup3r_tpu_torch.ops.subpixel import subpixel_tail_conv
from sup3r_tpu_torch.utilities import trace

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
    #: hand-written ``reflect_conv`` kernel, whatever its shape (set from
    #: ``Sup3rGan.inference_pallas``); off, ``kernels.body_kernel_wins``
    #: decides
    use_pallas = False

    #: route tiny-channel 3D convs (``kernels.small_kernel_wins``, e.g.
    #: the flagship generator's final 8->2 conv at HR resolution) to the
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
        #: the ``reflect_conv`` packing of the conv's weight
        self.packed_weights = kernels.PackedWeights()

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

    def route(self, x, ctx):
        """The route a call on ``x`` (channels-first) with ``ctx`` takes
        (``ops/kernels.py`` describes each): 'halo' or, for a block the
        small kernel would take, 'small_halo' (a block of s1 rows under a
        spatial mesh), 'gather_small', 'small', 'body' or 'library'. Reads
        ``x``'s shape, dtype and device, the grad mode, ``ctx['spatial']``
        and the block's flags; runs nothing."""
        small = self.small_channel_kernel and kernels.small_kernel_wins(
            x, self.conv.filters)
        shard = ctx.get('spatial')
        if shard is not None:
            if small:
                return 'gather_small' if shard.gather_small else 'small_halo'
            return 'halo'
        if small:
            return 'small'
        if not torch.is_grad_enabled() and (
                (self.use_pallas and x.is_cuda)
                or kernels.body_kernel_wins(x)):
            return 'body'
        return 'library'

    def forward(self, x, ctx):
        route = self.route(x, ctx)
        counter = _COUNTERS.get(route)
        if counter is not None:
            trace.count(counter)
        weight = self.conv.fused_weight(x.dtype)
        bias = self.bias.to(x.dtype)
        shard = ctx.get('spatial')
        if route in ('halo', 'small_halo'):
            return reflect_conv_halo(x, weight, bias, self.n_spatial,
                                     self.alpha, *shard.halo(x))
        if route == 'gather_small':
            # the whole tensor through the kernel; this rank's rows out
            start, count = shard.block(ctx['s1'])
            y = small_reflect_conv_cf(shard.gather(x, ctx['s1']), weight,
                                      bias, self.alpha)
            return y.narrow(2, start, count)
        if route == 'small' and x.is_cuda:
            return small_reflect_conv_cf(x, weight, bias, self.alpha)
        if route == 'body':
            return self.packed_weights.reflect_conv(
                x, self.conv.weight, weight, bias, self.alpha)
        # 'library', and 'small' on the CPU (the kernels' plain version)
        if self.shard_aligned:
            return reflect_conv_shard_aligned(x, weight, bias,
                                              self.n_spatial, self.alpha)
        return reflect_conv_ad(x, weight, bias, self.n_spatial, self.alpha)


#: the counter of each route of a block the small kernel does not take
_COUNTERS = {'body': 'fuse.body_kernel', 'library': 'fuse.body_cudnn',
             'halo': 'fuse.body_cudnn'}


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
