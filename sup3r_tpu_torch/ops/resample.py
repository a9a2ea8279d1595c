"""PIL's image resampling, on tensors on any device.

``SurfaceSpatialMetModel`` of the JAX package resizes each 2D field with
``PIL.Image.resize`` on a mode-'F' image. The card's machine has no PIL,
so the port builds the same resampling here: Pillow's separable
convolution filters (``Resample.c``, ``precompute_coeffs``) as two dense
weight matrices, applied as ``W_h @ X @ W_w^T`` over a batch of fields.

The rule, for a filter of support ``s`` resizing ``n_in`` cells to
``n_out``: ``scale = n_in / n_out``, ``fscale = max(scale, 1)`` and the
support is ``s * fscale``. Output cell ``i`` has centre ``(i + 0.5) *
scale``; its taps run from ``max(int(centre - support + 0.5), 0)`` to
``min(int(centre + support + 0.5), n_in)`` (exclusive), tap ``x`` weighs
``filter((x - centre + 0.5) / fscale)``, and each row is normalized to
sum 1. Edges are truncated, not reflected. Pillow passes the width
first, then the height, in double precision with a float32 image between
the passes; the matrices here are float64 and the products run in the
field's dtype.
"""

import numpy as np
import torch


def _box(x):
    return np.where((x > -0.5) & (x <= 0.5), 1.0, 0.0)


def _triangle(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _hamming(x):
    x = np.abs(x)
    px = np.pi * np.where(x == 0, 1.0, x)
    w = np.sin(px) / px * (0.54 + 0.46 * np.cos(px))
    return np.where(x == 0, 1.0, np.where(x >= 1.0, 0.0, w))


def _bicubic(x, a=-0.5):
    x = np.abs(x)
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    outer = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def _sinc(x):
    px = np.pi * np.where(x == 0, 1.0, x)
    return np.where(x == 0, 1.0, np.sin(px) / px)


def _lanczos(x):
    return np.where((x >= -3.0) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


#: Pillow's convolution filters by ``PIL.Image.Resampling`` name:
#: (support, filter)
FILTERS = {
    'BOX': (0.5, _box),
    'BILINEAR': (1.0, _triangle),
    'HAMMING': (1.0, _hamming),
    'BICUBIC': (2.0, _bicubic),
    'LANCZOS': (3.0, _lanczos),
}


def check_method(method):
    """The upper-case filter name of ``method``; raises for a method
    this module does not build."""
    name = str(method).upper()
    if name not in FILTERS:
        raise ValueError(f'interp_method {method!r} is not supported; '
                         f'supported: {sorted(FILTERS)}')
    return name


def resample_weights(n_in, n_out, method='LANCZOS'):
    """(n_out, n_in) float64 matrix of Pillow's resampling of one axis
    from ``n_in`` to ``n_out`` cells."""
    support, filt = FILTERS[check_method(method)]
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = support * fscale
    weights = np.zeros((n_out, n_in))
    for i in range(n_out):
        centre = (i + 0.5) * scale
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), n_in)
        taps = np.arange(lo, hi)
        w = filt((taps - centre + 0.5) / fscale)
        total = w.sum()
        weights[i, lo:hi] = w / total if total != 0.0 else w
    return weights


_CACHE = {}


def _weights(n_in, n_out, method, dtype, device):
    key = (n_in, n_out, method, dtype, str(device))
    if key not in _CACHE:
        _CACHE[key] = torch.as_tensor(
            resample_weights(n_in, n_out, method), dtype=dtype,
            device=device)
    return _CACHE[key]


def resize(fields, out_shape, method='LANCZOS'):
    """Resize the last two axes of ``fields`` (a tensor ``(..., h, w)``)
    to ``out_shape`` (h', w') as ``PIL.Image.resize`` resizes a mode-'F'
    image, in the tensor's dtype on its device."""
    method = check_method(method)
    h, w = fields.shape[-2:]
    wh = _weights(h, out_shape[0], method, fields.dtype, fields.device)
    ww = _weights(w, out_shape[1], method, fields.dtype, fields.device)
    return torch.matmul(wh, torch.matmul(fields, ww.T))

