"""Reflect-pad-1 + valid k3 conv + bias + activation block (forward).

The fused generator blocks run this composition by default: a 1-cell
reflect pad (``F.pad``), then ``F.conv3d`` / ``F.conv2d`` with the bias,
then LeakyReLU. On the card the convolution goes to cuDNN, as the JAX
package left it to XLA's conv emitter
(``sup3r_tpu/ops/conv_ad.py::reflect_conv_ad``). Tensors are
channels-first: ``(n, c, s1, s2[, t])`` with OI.. kernels.

The custom backward (halo fold) and the shard-aligned variant come with
the training and multi-device slices of the port.
"""

import torch.nn.functional as F

__all__ = ['reflect_conv_ad']


def _check_k3(weight, n_spatial):
    """The fused block is a k=3 reflect-boundary conv on every spatial
    dim; any other kernel would silently compute something else."""
    taps = tuple(weight.shape[2:])
    if taps != (3,) * n_spatial:
        raise ValueError(
            f'reflect_conv ops require a k=3 kernel on every spatial '
            f'dim; got spatial taps {taps} (weight shape '
            f'{tuple(weight.shape)})')


def reflect_conv_ad(x, weight, bias, n_spatial, alpha):
    """reflect-pad-1 -> k3/s1 valid conv -> +bias -> LeakyReLU(alpha).

    x: (n, ci, *spatial); weight: (co, ci, 3, 3[, 3]); bias: (co,).
    ``alpha=None`` skips the activation."""
    _check_k3(weight, n_spatial)
    xp = F.pad(x, (1, 1) * n_spatial, mode='reflect')
    conv = F.conv3d if n_spatial == 3 else F.conv2d
    y = conv(xp, weight, bias)
    if alpha is not None:
        y = F.leaky_relu(y, alpha)
    return y
