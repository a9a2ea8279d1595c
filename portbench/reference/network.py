"""A plain PyTorch reading of a sup3r ``hidden_layers`` list.

Each layer runs as the published list states it: a reflect pad of 3, a
'valid' convolution and a crop of 2 stay three operations (the program
fuses them into one reflect convolution; this file does not). Tensors
are channels-first; ``Flatten`` flattens in the channels-last order of
the published (TensorFlow) models. Imports torch alone.

Weights are held as a flat list of tensors, two per ``Conv2D`` /
``Conv3D`` / ``Dense`` layer in list order: the torch-layout weight
(``(co, ci, *k)`` for a convolution, ``(out, in)`` for a dense layer)
and the bias.
"""

import math

import torch
import torch.nn.functional as F

CONV_CLASSES = ('Conv2D', 'Conv3D')


def expand_layers(layers):
    """The layer list with every ``{'n': k, 'repeat': [...]}`` group
    written out ``k`` times."""
    if isinstance(layers, dict):
        layers = layers['hidden_layers']
    out = []
    for layer in layers:
        if 'repeat' in layer:
            for _ in range(int(layer['n'])):
                out.extend(expand_layers(layer['repeat']))
        else:
            out.append(layer)
    return out


def _tuple(value, n):
    return tuple(value) if isinstance(value, (list, tuple)) else (value,) * n


def walk_shapes(layers, in_shape):
    """Channels-last shape after each layer for a channels-last input
    ``(n, *spatial, c)``; Sup3rConcat adds one channel. Returns a list of
    ``(layer, input shape, output shape)``."""
    shape = tuple(in_shape)
    out = []
    for layer in expand_layers(layers):
        cls = layer['class']
        n, *spatial, c = shape
        if cls == 'FlexiblePadding':
            pads = layer['paddings']
            new = tuple(s + a + b for s, (a, b) in zip(shape, pads))
        elif cls in ('Cropping2D', 'Cropping3D'):
            crop = layer['cropping']
            new = (n, *(s - 2 * crop for s in spatial), c)
        elif cls in CONV_CLASSES:
            k = _tuple(layer['kernel_size'], len(spatial))
            st = _tuple(layer.get('strides', 1), len(spatial))
            if str(layer.get('padding', 'valid')).lower() == 'same':
                sp = [-(-s // t) for s, t in zip(spatial, st)]
            else:
                sp = [(s - kk) // t + 1 for s, kk, t in zip(spatial, k, st)]
            new = (n, *sp, int(layer['filters']))
        elif cls == 'SpatioTemporalExpansion':
            sm = int(layer.get('spatial_mult', 1))
            tm = int(layer.get('temporal_mult', 1))
            cc = c // tm if layer.get('temporal_method') == 'depth_to_time' \
                else c
            new = (n, spatial[0] * sm, spatial[1] * sm, spatial[2] * tm,
                   cc // (sm * sm))
        elif cls == 'SpatialExpansion':
            sm = int(layer['spatial_mult'])
            new = (n, spatial[0] * sm, spatial[1] * sm, c // (sm * sm))
        elif cls == 'Sup3rConcat':
            new = (*shape[:-1], c + 1)
        elif cls == 'Flatten':
            new = (n, math.prod(shape[1:]))
        elif cls == 'Dense':
            new = (*shape[:-1], int(layer['units']))
        elif cls in ('LeakyReLU', 'SkipConnection'):
            new = shape
        else:
            raise ValueError(f'no plain reading of layer class {cls}')
        out.append((layer, shape, new))
        shape = new
    return out


def param_shapes(layers, in_shape):
    """[(weight shape, bias shape)] of each parameterised layer, in list
    order, for a channels-last input shape."""
    shapes = []
    for layer, shape_in, shape_out in walk_shapes(layers, in_shape):
        if layer['class'] in CONV_CLASSES:
            k = _tuple(layer['kernel_size'], len(shape_in) - 2)
            shapes.append(((shape_out[-1], shape_in[-1], *k),
                           (shape_out[-1],)))
        elif layer['class'] == 'Dense':
            shapes.append(((shape_out[-1], shape_in[-1]), (shape_out[-1],)))
    return shapes


def depth_to_space(x, r):
    """TensorFlow-ordered depth to space on a channels-first tensor
    ``(n, r*r*c, h, w, *rest)``: source channel ``(i*r + j)*c + k`` goes
    to cell ``(h*r + i, w*r + j)``, channel ``k``."""
    n, d, h, w, *rest = x.shape
    c = d // (r * r)
    out = x.new_empty((n, c, h * r, w * r, *rest))
    for i in range(r):
        for j in range(r):
            block = x[:, (i * r + j) * c:(i * r + j + 1) * c]
            out[:, :, i::r, j::r] = block
    return out


def depth_to_time(x, m):
    """Temporal pixel shuffle on ``(n, c, s1, s2, t)``: channel
    ``j*(c/m) + k`` of step ``t`` goes to step ``t*m + j``, channel
    ``k``."""
    n, c, s1, s2, t = x.shape
    cc = c // m
    out = x.new_empty((n, cc, s1, s2, t * m))
    for j in range(m):
        out[..., j::m] = x[:, j * cc:(j + 1) * cc]
    return out


def reflect_pad(x, pads):
    """numpy's 'reflect' pad of a channels-first tensor's spatial dims by
    ``pads`` ((before, after) a dim), of any width (reflections repeat
    where the pad is wider than the dim)."""
    for d, (before, after) in enumerate(pads, start=2):
        n = x.shape[d]
        i = torch.arange(-before, n + after, device=x.device)
        if n == 1:
            i = torch.zeros_like(i)
        else:
            i = torch.remainder(i, 2 * (n - 1))
            i = torch.where(i >= n, 2 * (n - 1) - i, i)
        x = x.index_select(d, i)
    return x


def leaky_relu(x, alpha):
    return torch.where(x >= 0, x, alpha * x)


def apply(layers, params, x, exo=None):
    """Run the layer list on channels-first ``x``. ``params`` is the flat
    [w0, b0, w1, b1, ...] list; ``exo`` maps a Sup3rConcat name to a
    channels-first raster shaped like the activation it joins."""
    exo = exo or {}
    skips = {}
    it = iter(params)
    for layer in expand_layers(layers):
        cls = layer['class']
        if cls == 'FlexiblePadding':
            if str(layer.get('mode', 'REFLECT')).upper() != 'REFLECT':
                raise ValueError(f'no plain reading of padding {layer}')
            x = reflect_pad(x, layer['paddings'][1:-1])
        elif cls in ('Cropping2D', 'Cropping3D'):
            c = int(layer['cropping'])
            x = x[(slice(None), slice(None))
                  + tuple(slice(c, s - c) for s in x.shape[2:])]
        elif cls in CONV_CLASSES:
            w, b = next(it), next(it)
            conv = F.conv3d if cls == 'Conv3D' else F.conv2d
            stride = _tuple(layer.get('strides', 1), x.ndim - 2)
            if str(layer.get('padding', 'valid')).lower() != 'valid':
                raise ValueError(f'no plain reading of conv {layer}')
            x = conv(x, w, b, stride=stride)
        elif cls == 'LeakyReLU':
            x = leaky_relu(x, float(layer.get('alpha', 0.3)))
        elif cls == 'SkipConnection':
            name = layer['name']
            if name in skips:
                x = x + skips.pop(name)
            else:
                skips[name] = x
        elif cls == 'SpatioTemporalExpansion':
            tm = int(layer.get('temporal_mult', 1))
            method = layer.get('temporal_method', 'nearest')
            if tm > 1:
                if method == 'nearest':
                    x = torch.repeat_interleave(x, tm, dim=4)
                elif method == 'depth_to_time':
                    x = depth_to_time(x, tm)
                else:
                    raise ValueError(f'temporal_method {method}')
                if layer.get('t_roll'):
                    x = torch.roll(x, int(layer['t_roll']), dims=4)
            sm = int(layer.get('spatial_mult', 1))
            if sm > 1:
                x = depth_to_space(x, sm)
        elif cls == 'SpatialExpansion':
            x = depth_to_space(x, int(layer['spatial_mult']))
        elif cls == 'Sup3rConcat':
            x = torch.cat([x, exo[layer['name']].to(x.dtype)], dim=1)
        elif cls == 'Flatten':
            x = x.movedim(1, -1).reshape(x.shape[0], -1)
        elif cls == 'Dense':
            w, b = next(it), next(it)
            x = x @ w.T + b
        else:
            raise ValueError(f'no plain reading of layer class {cls}')
    if skips or next(it, None) is not None:
        raise ValueError(f'unclosed skips {sorted(skips)} or params left')
    return x
