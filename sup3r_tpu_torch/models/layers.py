"""JSON layer-DSL interpreter: ``hidden_layers`` configs -> PyTorch
modules (the port of ``sup3r_tpu/models/layers.py``).

Each entry becomes a layer module with:

  * ``out_shape(in_shape)``: the static output shape, in the JAX
    package's channels-last layout ``(n, s1, s2[, t], c)``;
  * ``init(in_shape, generator)``: creates the parameters (on the CPU,
    from a seeded ``torch.Generator``) and returns ``out_shape``;
  * ``load_jax(params)``: loads the JAX package's per-layer param dict
    (numpy arrays; conv kernels in DHWIO / HWIO), and
    ``params_to_jax()`` gives it back;
  * ``forward(x, ctx)``: runs on CHANNELS-FIRST tensors ``(n, c, s1,
    s2[, t])``, the layout the port's network runs in (time on the
    contiguous axis). ``ctx`` carries the skip-connection cache and the
    exogenous rasters.

Layouts: conv weights are OIDHW / OIHW; transposed-conv weights are in
``conv_transpose``'s (I, O, ...) layout holding the spatially FLIPPED
JAX kernel, because ``jax.lax.conv_transpose`` (no ``transpose_kernel``)
correlates the zero-dilated, zero-padded input with the kernel as-is
while ``F.conv_transpose*d`` is the true adjoint of a correlation.

``Dropout`` draws its mask from the ``torch.Generator`` the caller puts
in ``ctx['dropout_generator']`` (and acts only with ``ctx['train']``);
the observation layers (``Sup3rConcatObs``, ``Sup3rObsModel``) read
sparse, NaN-filled observation rasters from ``ctx['exo']``.

Under a spatial mesh ``ctx['spatial']`` holds a
``parallel.mesh.SpatialShard``, each rank's tensor is its block of s1
rows and ``ctx['s1']`` the activation's global s1 rows, split over the
ranks as ``even_split`` splits them. A layer with ``sharded_form`` runs
on the block, differentiably:

  * the elementwise layers and skip connections as they are; Dropout on
    its rows of the global batch's mask;
  * expansions: a block of rows expands into r times the rows (blocks of
    equal rows only);
  * the exo layers on their raster's rows at the layer's resolution;
  * convs: a stride-1 'same' conv after a halo exchange (zero rows at
    the global edges); any other (strided, 'valid') on the input rows
    its block of the even split of the OUTPUT rows reads
    (``redistribute_rows``);
  * ``Flatten`` then ``Dense``: the flattened block is a contiguous
    slice of the flattened sample (s1 is outermost), so the ``Dense``
    is row-parallel: the block times its rows of the kernel, summed over
    the ranks (``sum_over_ranks``), the bias added once after the sum.
    From there on the activation is whole on every rank and the layers
    run as on one device (``Network.space_replicated_params``).

``Network`` refuses the others with a ValueError that says why.
"""

import inspect
import logging
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sup3r_tpu_torch.parallel.mesh import sum_over_ranks

logger = logging.getLogger(__name__)

ACTIVATIONS = {
    'relu': F.relu,
    'sigmoid': torch.sigmoid,
    'tanh': torch.tanh,
    'elu': F.elu,
    # jax.nn.gelu defaults to the tanh approximation
    'gelu': lambda x: F.gelu(x, approximate='tanh'),
    # channels-first: the JAX package's last (channel) axis is dim 1
    'softmax': lambda x: F.softmax(x, dim=1),
    'softplus': F.softplus,
    'linear': lambda x: x,
}


def _get_activation(name):
    if name is None:
        return None
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise KeyError(f'Unknown activation "{name}"')
    return ACTIVATIONS[key]


def _pair(v, n):
    """Normalize an int or sequence into an n-tuple."""
    if isinstance(v, (int, float)):
        return (int(v),) * n
    v = tuple(int(x) for x in v)
    if len(v) == 1:
        return v * n
    if len(v) != n:
        raise ValueError(f'Expected {n} values, got {v}')
    return v


def _glorot_uniform(shape, generator):
    """``jax.nn.initializers.glorot_uniform`` for a (..., in, out)
    kernel: U(-l, l), l = sqrt(6 / (fan_in + fan_out)). The draws come
    from ``generator``, so they differ from JAX's for the same seed."""
    receptive = math.prod(shape[:-2])
    limit = math.sqrt(6.0 / (receptive * (shape[-2] + shape[-1])))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def _tensor(array):
    """A float32 CPU tensor copy of a numpy array / tensor."""
    if isinstance(array, torch.Tensor):
        return array.detach().to('cpu', torch.float32).clone()
    return torch.tensor(np.asarray(array, np.float32))


def _param(array):
    """Frozen parameter from a numpy array / tensor; training turns
    ``requires_grad`` on (``Sup3rGan.init_weights``)."""
    return nn.Parameter(_tensor(array), requires_grad=False)


def _numpy(tensor):
    """A contiguous float32 numpy copy of a parameter (any device)."""
    return np.ascontiguousarray(
        tensor.detach().cpu().numpy().astype(np.float32))


def _spatial_to_cf(ndim):
    """Channels-last axis -> channels-first dim, for a rank-``ndim``
    tensor."""
    return [0, *range(2, ndim), 1]


class Layer(nn.Module):
    """Base layer: stateless identity."""

    #: class-level enhancement attributes read by enhancement inference
    spatial_mult = 1
    temporal_mult = 1

    #: whether the layer runs on a block of s1 rows under a spatial mesh
    #: (``ctx['spatial']``)
    sharded_form = False

    #: why a layer without ``sharded_form`` has none
    unsharded_reason = 'it has no spatially sharded form'

    def init(self, in_shape, generator):
        """Create parameters for the given input shape; returns the
        output shape."""
        return self.out_shape(in_shape)

    def out_shape(self, in_shape):
        """Output shape (channels-last) for the given input shape."""
        return in_shape

    def load_jax(self, params):
        """Load the JAX package's param dict for this layer. A param
        of the same shape is overwritten in place (it keeps its device,
        its ``requires_grad`` and the optimizer's hold on it)."""
        for name, value in self.tensors_from_jax(params).items():
            old = getattr(self, name, None)
            if isinstance(old, nn.Parameter) and old.shape == value.shape:
                with torch.no_grad():
                    old.copy_(value)
            else:
                setattr(self, name, _param(value))

    def params_to_jax(self):
        """This layer's param dict in the JAX package's layout (numpy
        float32): the inverse of ``load_jax``."""
        return self.tensors_to_jax(dict(self.named_parameters()))

    def tensors_from_jax(self, params):
        """{param name: tensor in the port's layout} of a dict of
        arrays in the JAX package's layout (params, or optimizer moments
        shaped like them), in parameter order."""
        if params:
            raise ValueError(f'{type(self).__name__} has no params, got '
                             f'{sorted(params)}')
        return {}

    def tensors_to_jax(self, tensors):
        """Inverse of ``tensors_from_jax``: numpy float32 arrays in the
        JAX package's layout, keyed as its param dicts are."""
        return {}

    def forward(self, x, ctx):
        raise NotImplementedError


class Activation(Layer):
    """Elementwise activation by name."""

    sharded_form = True

    def __init__(self, activation='relu', **_):
        super().__init__()
        self._fn = _get_activation(activation)
        self.name = activation

    def forward(self, x, ctx):
        return self._fn(x)


class LeakyReLU(Layer):
    """Leaky ReLU with configurable negative slope."""

    sharded_form = True

    def __init__(self, alpha=0.3, **_):
        super().__init__()
        self.alpha = float(alpha)

    def forward(self, x, ctx):
        # jax.nn.leaky_relu: the same values as F.leaky_relu, but its
        # gradient at exactly 0 is 1, not alpha
        return torch.where(x >= 0, x, self.alpha * x)


class Dropout(Layer):
    """Inverted dropout: active only when ``ctx['train']`` is set and
    ``ctx['dropout_generator']`` holds a ``torch.Generator``, whose draws
    (on its own device) make the keep mask. With ``ctx['dropout_rows']``
    (rank index i of n, each rank holding an equal block of the global
    batch) the mask is drawn for the whole global batch and this rank
    keeps its block i: a data-parallel step masks each sample as one
    device would. On a block of s1 rows (``ctx['spatial']``) the mask
    is drawn for the global s1 rows too and the rank keeps its block."""

    sharded_form = True

    def __init__(self, rate=0.5, **_):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, ctx):
        generator = ctx.get('dropout_generator')
        if not ctx.get('train') or generator is None or self.rate <= 0:
            return x
        keep = 1.0 - self.rate
        index, n = ctx.get('dropout_rows') or (0, 1)
        rows = x.shape[0]
        shape = [n * rows, *x.shape[1:]]
        shard = ctx.get('spatial')
        if shard is not None:
            shape[2] = ctx['s1']
        mask = torch.rand(shape, generator=generator,
                          device=generator.device)[
                              index * rows:(index + 1) * rows]
        if shard is not None:
            mask = mask.narrow(2, *shard.block(ctx['s1']))
        return torch.where(mask.to(x.device) < keep, x / keep, 0.0)


class Flatten(Layer):
    """Collapse all non-batch dims, in the channels-last order the JAX
    package flattens (so a following Dense sees the same features). On
    a block of s1 rows the block's features are a contiguous slice of
    the sample's (s1 is outermost): ``ctx['row_parallel']`` gets the
    slice's first feature, for the row-parallel ``Dense`` that must
    follow."""

    sharded_form = True

    def out_shape(self, in_shape):
        return (in_shape[0], int(np.prod(in_shape[1:])))

    def forward(self, x, ctx):
        shard = ctx.get('spatial')
        if shard is not None:
            row = int(np.prod(x.shape[3:])) * x.shape[1]
            ctx['row_parallel'] = shard.block(ctx['s1'])[0] * row
        return x.movedim(1, -1).reshape(x.shape[0], -1)


class Dense(Layer):
    """Affine map on the channel axis (Keras Dense semantics)."""

    def __init__(self, units, activation=None, **_):
        super().__init__()
        self.units = int(units)
        self._act = _get_activation(activation)

    def out_shape(self, in_shape):
        return (*in_shape[:-1], self.units)

    def init(self, in_shape, generator):
        kernel = _glorot_uniform((in_shape[-1], self.units), generator)
        self.load_jax({'kernel': kernel, 'bias': np.zeros(self.units)})
        return self.out_shape(in_shape)

    def tensors_from_jax(self, params):
        # torch's (out, in) layout for F.linear
        return {'weight': _tensor(params['kernel']).T.contiguous(),
                'bias': _tensor(params['bias'])}

    def tensors_to_jax(self, tensors):
        return {'kernel': _numpy(tensors['weight'].T),
                'bias': _numpy(tensors['bias'])}

    sharded_form = True

    def forward(self, x, ctx):
        # the params run in the input's dtype (bf16 training casts the
        # input); the cast is differentiable, so the float32 params get
        # float32 gradients
        weight, bias = self.weight.to(x.dtype), self.bias.to(x.dtype)
        offset = ctx.pop('row_parallel', None)
        if offset is not None:
            # row-parallel: this block's features times its rows of the
            # kernel, summed over the ranks; the bias once, after the sum
            shard = ctx['spatial']
            part = F.linear(x, weight.narrow(1, offset, x.shape[1]))
            y = sum_over_ranks(shard.mesh, part, shard.axis) + bias
            ctx['spatial'] = None  # whole on every rank from here on
        else:
            y = F.linear(x.movedim(1, -1), weight, bias).movedim(-1, 1)
        return self._act(y) if self._act else y


def _pad_index(n, before, after, mode):
    """Source indices of a ``jnp.pad`` reflect/symmetric pad of a
    length-``n`` axis (any width: reflections repeat, as numpy's do)."""
    i = np.arange(-before, n + after)
    if mode == 'reflect':
        if n == 1:
            return np.zeros_like(i)
        period = 2 * (n - 1)
        i = np.mod(i, period)
        return np.where(i >= n, period - i, i)
    period = 2 * n  # symmetric: the edge cell repeats
    i = np.mod(i, period)
    return np.where(i >= n, period - 1 - i, i)


class FlexiblePadding(Layer):
    """Pad with explicit per-dim widths and a numpy-style mode.

    Config gives TF-style ``paddings`` including batch/channel dims,
    e.g. ``[[0,0],[3,3],[3,3],[0,0]]``. ``F.pad`` has no 'symmetric'
    mode, so reflect and symmetric pads gather along each padded dim by
    index math (``_pad_index``); constant pads go through ``F.pad``."""

    unsharded_reason = (
        'a pad of s1 (reflect, symmetric or constant) takes rows from or '
        'adds rows at the global edges only; fuse it with its conv and '
        'crop (train_fuse / inference_fuse, the defaults) into one '
        'reflect conv, which has a sharded form')

    def __init__(self, paddings, mode='REFLECT', **_):
        super().__init__()
        self.paddings = tuple(tuple(int(v) for v in p) for p in paddings)
        self.mode = {'REFLECT': 'reflect', 'CONSTANT': 'constant',
                     'SYMMETRIC': 'symmetric'}[str(mode).upper()]

    def out_shape(self, in_shape):
        return tuple(s + a + b for s, (a, b) in zip(in_shape, self.paddings))

    def forward(self, x, ctx):
        dims = _spatial_to_cf(x.ndim)
        if self.mode == 'constant':
            # F.pad lists (before, after) from the LAST channels-first dim
            cl_of = {cf: cl for cl, cf in enumerate(dims)}
            flat = [w for d in reversed(range(x.ndim))
                    for w in self.paddings[cl_of[d]]]
            return F.pad(x, flat)
        for cl_axis, (a, b) in enumerate(self.paddings):
            if a or b:
                d = dims[cl_axis]
                idx = _pad_index(x.shape[d], a, b, self.mode)
                x = x.index_select(d, torch.as_tensor(idx, device=x.device))
        return x


class _Cropping(Layer):
    """Shared implementation for Cropping2D/3D (Keras semantics: int =
    same crop both sides of every spatial dim)."""

    n_spatial = 2
    unsharded_reason = (
        'a crop of s1 drops rows at the global edges only; fuse it with '
        'its pad and conv (train_fuse / inference_fuse, the defaults)')

    def __init__(self, cropping=0, **_):
        super().__init__()
        if isinstance(cropping, int):
            crops = ((cropping, cropping),) * self.n_spatial
        else:
            crops = tuple(
                (c, c) if isinstance(c, int) else tuple(c) for c in cropping)
        self.crops = crops

    def out_shape(self, in_shape):
        spatial = [
            s - a - b
            for s, (a, b) in zip(in_shape[1:1 + self.n_spatial], self.crops)
        ]
        return (in_shape[0], *spatial, *in_shape[1 + self.n_spatial:])

    def forward(self, x, ctx):
        idx = [slice(None), slice(None)]
        for d, (a, b) in enumerate(self.crops):
            idx.append(slice(a, x.shape[2 + d] - b))
        return x[tuple(idx)]


class Cropping2D(_Cropping):
    """Crop spatial dims of a 4D tensor."""

    n_spatial = 2


class Cropping3D(_Cropping):
    """Crop the three inner dims of a 5D tensor."""

    n_spatial = 3


def _same_pads(size, k, stride):
    """(before, after) of TF / ``jax.lax`` 'SAME' padding on one dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _transpose_pads(k, stride, padding):
    """(before, after) zero padding of the dilated input in
    ``jax.lax.conv_transpose`` (``_conv_transpose_padding``)."""
    if padding == 'SAME':
        pad_len = k + stride - 2
        pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    else:
        pad_len = k + stride - 2 + max(k - stride, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


class _ConvBase(Layer):
    """Shared init/validation for conv layers."""

    n_spatial = 2
    transpose = False
    sharded_form = True

    def __init__(self, filters, kernel_size, strides=1, padding='valid',
                 activation=None, **_):
        super().__init__()
        self.filters = int(filters)
        self.kernel_size = _pair(kernel_size, self.n_spatial)
        self.strides = _pair(strides, self.n_spatial)
        self.padding = str(padding).upper()
        self._act = _get_activation(activation)

    def out_shape(self, in_shape):
        spatial = []
        for s, k, st in zip(in_shape[1:1 + self.n_spatial],
                            self.kernel_size, self.strides):
            if self.transpose:
                if self.padding == 'VALID':
                    spatial.append((s - 1) * st + k)
                else:
                    spatial.append(s * st)
            elif self.padding == 'VALID':
                spatial.append((s - k) // st + 1)
            else:
                spatial.append(-(-s // st))
        return (in_shape[0], *spatial, self.filters)

    def init(self, in_shape, generator):
        kshape = (*self.kernel_size, in_shape[-1], self.filters)
        self.load_jax({'kernel': _glorot_uniform(kshape, generator),
                       'bias': np.zeros(self.filters)})
        return self.out_shape(in_shape)

    def tensors_from_jax(self, params):
        """DHWIO / HWIO kernel -> OIDHW / OIHW weight; for a transposed
        conv, the spatially flipped kernel in (I, O, ...) layout."""
        kernel = _tensor(params['kernel'])
        n = self.n_spatial
        if self.transpose:
            kernel = kernel.flip(tuple(range(n))).permute(n, n + 1,
                                                          *range(n))
        else:
            kernel = kernel.permute(n + 1, n, *range(n))
        return {'weight': kernel.contiguous(),
                'bias': _tensor(params['bias'])}

    def tensors_to_jax(self, tensors):
        """OIDHW / OIHW weight -> DHWIO / HWIO kernel; for a transposed
        conv, the (I, O, ...) weight flipped back spatially."""
        weight = tensors['weight'].detach()
        n = self.n_spatial
        if self.transpose:
            kernel = weight.permute(*range(2, 2 + n), 0, 1).flip(
                tuple(range(n)))
        else:
            kernel = weight.permute(*range(2, 2 + n), 1, 0)
        return {'kernel': _numpy(kernel), 'bias': _numpy(tensors['bias'])}

    def fused_weight(self, dtype=None):
        """The OI.. weight of the equivalent correlation: a stride-1
        VALID ``jax.lax.conv_transpose`` is a full-padding correlation
        with the JAX kernel as-is (models/fuse.py). ``dtype`` casts it
        (differentiably: the gradient reaches the float32 param)."""
        weight = self.weight if dtype is None else self.weight.to(dtype)
        if not self.transpose:
            return weight
        n = self.n_spatial
        return weight.flip(tuple(range(2, 2 + n))).transpose(
            0, 1).contiguous()

    def _sharded_input(self, x, ctx):
        """The input rows this rank's block of the conv's output rows
        reads (the even split of the global output rows), with zero rows
        for 'same' padding past a global edge; sets ``ctx['s1']`` to the
        output's global rows. A stride-1 'same' conv whose every input
        block holds its halo's rows takes them from its neighbours
        (``halo_exchange``); any other reads them through
        ``redistribute_rows``."""
        if self.transpose:
            raise ValueError(
                f'{type(self).__name__} has no spatially sharded form: a '
                'transposed conv spreads each row over strided output rows; '
                'fuse it with its pad and crop (train_fuse / '
                'inference_fuse, the defaults) into one reflect conv')
        shard, n = ctx['spatial'], ctx['s1']
        k, stride = self.kernel_size[0], self.strides[0]
        if self.padding == 'SAME':
            n_out = -(-n // stride)
            before, after = _same_pads(n, k, stride)
        else:
            n_out = (n - k) // stride + 1
            before, after = 0, 0
        ctx['s1'] = n_out
        split = shard.split(n)
        if (stride == 1 and self.padding == 'SAME' and (before or after)
                and all(c >= max(before, after) for _, c in split)):
            top, bottom = shard.halo(x, 2, before, after)

            def rows(t, m):
                return x.new_zeros((*x.shape[:2], m, *x.shape[3:])) if (
                    t is None) else t

            return torch.cat([rows(top, before), x, rows(bottom, after)],
                             dim=2)
        needs, pads = [], []
        for start, count in shard.split(n_out):
            lo = start * stride - before
            hi = lo + (count - 1) * stride + k if count else lo
            needs.append((min(max(lo, 0), n), max(min(hi, n), 0)))
            pads.append((needs[-1][0] - lo if count else 0,
                         hi - needs[-1][1] if count else 0))
        needs = [(lo, max(lo, hi)) for lo, hi in needs]
        rows = shard.redistribute(x, n, needs)
        top, bottom = pads[shard.index]
        if top or bottom:
            shape = list(rows.shape)
            rows = torch.cat([rows.new_zeros([*shape[:2], top, *shape[3:]]),
                              rows,
                              rows.new_zeros([*shape[:2], bottom,
                                              *shape[3:]])], dim=2)
        return rows

    def _conv_rows(self, conv, x, weight, bias):
        """The conv of a block of input rows (valid on s1). A rank with
        no output rows runs it on an empty batch: its graph, and so its
        backward's collectives, stay those of the other ranks."""
        if x.shape[2]:
            return conv(x, weight, bias, self.strides)
        n, c = x.shape[:2]
        y = conv(x.reshape(0, c, self.kernel_size[0], *x.shape[3:]), weight,
                 bias, self.strides)
        return y.reshape(n, y.shape[1], 0, *y.shape[3:])

    def forward(self, x, ctx):
        # params in the input's dtype, as the JAX layers cast them
        weight, bias = self.weight.to(x.dtype), self.bias.to(x.dtype)
        shard = ctx.get('spatial')
        if shard is not None:
            x = self._sharded_input(x, ctx)
        if self.transpose:
            conv = F.conv_transpose3d if self.n_spatial == 3 else (
                F.conv_transpose2d)
            y = conv(x, weight, None, self.strides)
            # the full transposed conv is jax's with (k-1, k-1) pads;
            # F.pad with negative widths crops
            flat = []
            for k, st in zip(reversed(self.kernel_size),
                             reversed(self.strides)):
                a, b = _transpose_pads(k, st, self.padding)
                flat += [a - (k - 1), b - (k - 1)]
            y = F.pad(y, flat) + bias.view(-1, *[1] * self.n_spatial)
        else:
            if self.padding == 'SAME':
                flat = []
                for s, k, st in zip(reversed(x.shape[2:]),
                                    reversed(self.kernel_size),
                                    reversed(self.strides)):
                    flat += list(_same_pads(s, k, st))
                if shard is not None:  # s1's rows came with the block
                    flat[-2:] = [0, 0]
                x = F.pad(x, flat)
            conv = F.conv3d if self.n_spatial == 3 else F.conv2d
            y = (conv(x, weight, bias, self.strides) if shard is None
                 else self._conv_rows(conv, x, weight, bias))
        return self._act(y) if self._act else y


class Conv2D(_ConvBase):
    """2D convolution (dims = s1, s2)."""

    n_spatial = 2


class Conv3D(_ConvBase):
    """3D convolution (dims = s1, s2, time)."""

    n_spatial = 3


class Conv2DTranspose(_ConvBase):
    """2D transposed convolution."""

    n_spatial = 2
    transpose = True


class Conv3DTranspose(_ConvBase):
    """3D transposed convolution."""

    n_spatial = 3
    transpose = True


def _depth_to_space(x, r):
    """TF-ordered depth_to_space on channels-first ``(n, r*r*c, h, w,
    *rest)`` -> ``(n, c, h*r, w*r, *rest)``: source channel ``(i*r +
    j)*c + k`` lands on output cell ``(h*r + i, w*r + j)``, channel
    ``k``. ``F.pixel_shuffle`` takes channel ``k*r*r + i*r + j``, so it
    is not this op."""
    n, d, h, w, *rest = x.shape
    c = d // (r * r)
    x = x.reshape(n, r, r, c, h, w, *rest)
    x = x.permute(0, 3, 4, 1, 5, 2, *range(6, x.ndim))
    return x.reshape(n, c, h * r, w * r, *rest)


def _expand_rows(ctx, layer):
    """Under a spatial mesh: a block of rows expands into ``spatial_mult``
    times the rows, which is the even split of the expanded rows only
    when the blocks hold equal rows (raises otherwise)."""
    shard = ctx.get('spatial')
    if shard is None or layer.spatial_mult == 1:
        return
    n = ctx['s1']
    if n % shard.size:
        raise ValueError(
            f'{type(layer).__name__} on a spatial mesh: {n} s1 rows over '
            f'{shard.size} ranks are blocks of unequal rows, whose '
            'expansions would not be the even split of the expanded rows')
    ctx['s1'] = n * layer.spatial_mult


class SpatialExpansion(Layer):
    """Pixel-shuffle spatial expansion of a 4D tensor.

    ``spatial_mult`` m maps channels c -> c / m^2 while upscaling both
    spatial dims by m.
    """

    sharded_form = True

    def __init__(self, spatial_mult=1, **_):
        super().__init__()
        self.spatial_mult = int(spatial_mult)

    def out_shape(self, in_shape):
        n, h, w, c = in_shape
        m = self.spatial_mult
        if c % (m * m):
            raise ValueError(
                f'SpatialExpansion(spatial_mult={m}) needs channels '
                f'divisible by {m * m}, got {c}')
        return (n, h * m, w * m, c // (m * m))

    def forward(self, x, ctx):
        self.out_shape((x.shape[0], *x.shape[2:], x.shape[1]))
        _expand_rows(ctx, self)
        return _depth_to_space(x, self.spatial_mult)


class SpatioTemporalExpansion(Layer):
    """Spatial pixel-shuffle and/or temporal expansion of a 5D tensor.

    temporal_method: 'nearest' repeats frames; 'linear' interpolates
    between frames onto the t*mult grid; 'depth_to_time' is a temporal
    pixel-shuffle moving channel blocks into new time steps (channels
    c -> c/mult). ``t_roll`` rolls the expanded time axis.
    """

    sharded_form = True

    def __init__(self, spatial_mult=1, temporal_mult=1,
                 temporal_method='nearest', t_roll=0, **_):
        super().__init__()
        self.spatial_mult = int(spatial_mult)
        self.temporal_mult = int(temporal_mult)
        self.temporal_method = temporal_method
        self.t_roll = int(t_roll)

    def out_shape(self, in_shape):
        n, s1, s2, t, c = in_shape
        m = self.spatial_mult
        if self.temporal_method == 'depth_to_time':
            if c % self.temporal_mult:
                raise ValueError(
                    f'depth_to_time with temporal_mult={self.temporal_mult} '
                    f'needs channels divisible by it, got {c}')
            c = c // self.temporal_mult
        if c % (m * m):
            raise ValueError(
                f'SpatioTemporalExpansion(spatial_mult={m}) needs channels '
                f'divisible by {m * m}, got {c}')
        return (n, s1 * m, s2 * m, t * self.temporal_mult, c // (m * m))

    def _expand_time(self, x):
        t_mult = self.temporal_mult
        if t_mult == 1:
            return x
        n, c, s1, s2, t = x.shape
        if self.temporal_method == 'nearest':
            out = x.repeat_interleave(t_mult, dim=4)
        elif self.temporal_method == 'depth_to_time':
            # channel j*(c/m) + k -> time t*m + j, channel k
            out = x.reshape(n, t_mult, c // t_mult, s1, s2, t)
            out = out.permute(0, 2, 3, 4, 5, 1).reshape(
                n, c // t_mult, s1, s2, t * t_mult)
        else:
            pos = torch.arange(t * t_mult, device=x.device,
                               dtype=torch.float32) / t_mult
            lo = pos.floor().long().clamp(0, t - 1)
            hi = (lo + 1).clamp(0, t - 1)
            w = (pos - lo).to(x.dtype)
            out = x[..., lo] * (1 - w) + x[..., hi] * w
        if self.t_roll:
            out = torch.roll(out, self.t_roll, dims=4)
        return out

    def forward(self, x, ctx):
        self.out_shape((x.shape[0], *x.shape[2:], x.shape[1]))
        _expand_rows(ctx, self)
        x = self._expand_time(x)
        if self.spatial_mult == 1:
            return x
        return _depth_to_space(x, self.spatial_mult)


class SkipConnection(Layer):
    """Named residual: first occurrence caches, second occurrence adds."""

    sharded_form = True

    def __init__(self, name, **_):
        super().__init__()
        self.name = name

    def forward(self, x, ctx):
        cache = ctx.setdefault('skips', {})
        if self.name in cache:
            start = cache.pop(self.name)
            if start.shape != x.shape:
                raise ValueError(
                    f'SkipConnection "{self.name}" shape mismatch: cached '
                    f'{tuple(start.shape)} vs current {tuple(x.shape)}')
            return x + start
        cache[self.name] = x
        return x


class _ExoLayerBase(Layer):
    """Base for mid-network exogenous data injection.

    ``ctx['exo']`` maps feature name -> channels-last tensor shaped like
    the current activation's spatial(/temporal) dims with trailing
    channel(s), as the JAX package takes it. Under a spatial mesh the
    raster is full-size and the layer takes its block of s1 rows."""

    sharded_form = True

    def __init__(self, name, **_):
        super().__init__()
        self.name = name

    def _get_exo(self, x, ctx):
        exo = ctx.get('exo') or {}
        if self.name not in exo:
            raise KeyError(
                f'Layer {type(self).__name__} requires exogenous feature '
                f'"{self.name}" but ctx only has {sorted(exo)}')
        t = exo[self.name]
        if t.ndim == x.ndim - 1:
            t = t[..., None]
        shard = ctx.get('spatial')
        if shard is not None:
            t = shard.rows(t, 1, ctx['s1'])
        # broadcast batch dim if exo was provided unbatched
        if t.ndim == x.ndim and t.shape[0] == 1 and x.shape[0] != 1:
            t = t.expand(x.shape[0], *t.shape[1:])
        return t.movedim(-1, 1).to(x.dtype)


class Sup3rAdder(_ExoLayerBase):
    """Add an exogenous raster to the current activation."""

    def forward(self, x, ctx):
        return x + self._get_exo(x, ctx)


class Sup3rConcat(_ExoLayerBase):
    """Concatenate an exogenous raster as extra channel(s)."""

    def out_shape(self, in_shape):
        return (*in_shape[:-1], in_shape[-1] + 1)

    def forward(self, x, ctx):
        return torch.cat([x, self._get_exo(x, ctx)], dim=1)


def _obs_and_mask(t):
    """``[obs with NaN -> 0, isfinite mask]`` of a channels-first
    observation raster: the zeros go in before any conv, so gradients
    stay finite."""
    mask = torch.isfinite(t)
    return torch.where(mask, t, 0.0), mask.to(t.dtype)


class Sup3rConcatObs(_ExoLayerBase):
    """Concatenate a (sparse, NaN-filled) observation raster and its
    validity mask as two extra channels."""

    def out_shape(self, in_shape):
        return (*in_shape[:-1], in_shape[-1] + 2)

    def forward(self, x, ctx):
        filled, mask = _obs_and_mask(self._get_exo(x, ctx))
        return torch.cat([x, filled, mask], dim=1)


class Sup3rObsModel(_ExoLayerBase):
    """Learned fusion of sparse observations: obs and mask through a
    1x1 projection (two with a LeakyReLU(0.2) between when ``filters``,
    the hidden width, is given) added to the activation. Params in the
    JAX package's layout: ``kernel`` (2, c or filters), ``bias``, and
    ``kernel_out`` (filters, c), ``bias_out``."""

    def __init__(self, name, filters=None, **_):
        super().__init__(name)
        self.filters = filters

    def init(self, in_shape, generator):
        c = in_shape[-1]
        if self.filters is None:
            self.load_jax({'kernel': _glorot_uniform((2, c), generator),
                           'bias': np.zeros(c)})
        else:
            h = int(self.filters)
            self.load_jax({'kernel': _glorot_uniform((2, h), generator),
                           'bias': np.zeros(h),
                           'kernel_out': _glorot_uniform((h, c), generator),
                           'bias_out': np.zeros(c)})
        return in_shape

    def tensors_from_jax(self, params):
        return {k: _tensor(params[k]) for k in
                ('kernel', 'bias', 'kernel_out', 'bias_out') if k in params}

    def tensors_to_jax(self, tensors):
        return {k: _numpy(v) for k, v in tensors.items()}

    def forward(self, x, ctx):
        filled, mask = _obs_and_mask(self._get_exo(x, ctx))
        obs_in = torch.cat([filled, mask], dim=1).movedim(1, -1)
        proj = obs_in @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)
        if hasattr(self, 'kernel_out'):
            proj = torch.where(proj >= 0, proj, 0.2 * proj)
            proj = (proj @ self.kernel_out.to(x.dtype)
                    + self.bias_out.to(x.dtype))
        return x + proj.movedim(-1, 1)


LAYER_REGISTRY = {
    'Activation': Activation,
    'LeakyReLU': LeakyReLU,
    'Dropout': Dropout,
    'Flatten': Flatten,
    'Dense': Dense,
    'FlexiblePadding': FlexiblePadding,
    'Cropping2D': Cropping2D,
    'Cropping3D': Cropping3D,
    'Conv2D': Conv2D,
    'Conv3D': Conv3D,
    'Conv2DTranspose': Conv2DTranspose,
    'Conv3DTranspose': Conv3DTranspose,
    'SpatialExpansion': SpatialExpansion,
    'SpatioTemporalExpansion': SpatioTemporalExpansion,
    'SkipConnection': SkipConnection,
    'Sup3rAdder': Sup3rAdder,
    'Sup3rConcat': Sup3rConcat,
    'Sup3rConcatObs': Sup3rConcatObs,
    'Sup3rObsModel': Sup3rObsModel,
}

#: layers that inject exogenous data mid-network
EXO_LAYERS = (Sup3rAdder, Sup3rConcat)
#: layers that fuse observations mid-network
OBS_LAYERS = (Sup3rConcatObs, Sup3rObsModel)


def build_layers(hidden_layers):
    """Expand a ``hidden_layers`` JSON list (including ``{"n": k,
    "repeat": [...]}`` blocks) into a flat list of layer modules."""
    layers = []
    for entry in hidden_layers:
        if 'repeat' in entry:
            n = int(entry.get('n', 1))
            block = entry['repeat']
            for _ in range(n):
                layers.extend(build_layers(block))
            continue
        entry = dict(entry)
        cls_name = entry.pop('class')
        if cls_name not in LAYER_REGISTRY:
            raise KeyError(
                f'Unknown layer class "{cls_name}". Known: '
                f'{sorted(LAYER_REGISTRY)}')
        cls = LAYER_REGISTRY[cls_name]
        # constructors tolerate unknown keys (**_) for TF-config
        # compatibility, but a misspelled option silently building a
        # DIFFERENT network is worse than noise — warn on every
        # unconsumed key
        named = {
            p for p, v in inspect.signature(
                cls.__init__).parameters.items()
            if v.kind in (v.POSITIONAL_OR_KEYWORD, v.KEYWORD_ONLY)
            and p != 'self'}
        unknown = set(entry) - named
        if unknown:
            logger.warning(
                'Layer %s ignores unsupported config key(s) %s '
                '(accepted: %s)', cls_name, sorted(unknown),
                sorted(named))
        layers.append(cls(**entry))
    return layers
