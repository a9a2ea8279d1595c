"""The chunked forward pass as sup3r defines it, in plain numpy / torch.

A low-res domain ``(s1, s2, t, f)`` is cut into chunks: spatial chunks
of the configured width from the origin, time chunks by a near-even
split into ``ceil(t / chunk_t)`` pieces. Each chunk reads its window
widened by the pads, reflected about the domain's edges where the
widened window leaves it, runs the model, and keeps the high-res cells
of its own window. Chunk ``k`` is spatial chunk ``k % n_spatial``
(row-major over (s1, s2)) of time chunk ``k // n_spatial``.
"""

import math

import numpy as np
import torch

from portbench.reference.network import apply


def reflect_index(start, stop, n):
    """Indices ``start..stop-1`` of an axis of length ``n``, reflected
    about its first and last cells (numpy's 'reflect')."""
    i = np.arange(start, stop)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def axis_chunks(n, width, split='fixed'):
    """[(start, stop)] of the chunks of an axis of length ``n``."""
    if split == 'fixed':
        return [(s, min(s + width, n)) for s in range(0, n, width)]
    pieces = np.array_split(np.arange(n), math.ceil(n / width))
    return [(int(p[0]), int(p[-1]) + 1) for p in pieces]


def chunk_plan(domain, chunk_shape, spatial_pad, temporal_pad):
    """[(index, ((s1 start, stop), (s2 ...), (t ...)))] of every chunk,
    in the pass's chunk order, with the pads of each axis."""
    s1 = axis_chunks(domain[0], chunk_shape[0])
    s2 = axis_chunks(domain[1], chunk_shape[1])
    ts = axis_chunks(domain[2], chunk_shape[2], split='even')
    spatial = [(a, b) for a in s1 for b in s2]
    plan = []
    for it, t in enumerate(ts):
        for isp, (a, b) in enumerate(spatial):
            plan.append((it * len(spatial) + isp, (a, b, t)))
    return plan, (spatial_pad, spatial_pad, temporal_pad)


def padded_window(data, window, pads, enhance=(1, 1, 1)):
    """The widened, edge-reflected window of ``data`` (axes 0-2 at the
    given enhancement of the low-res grid)."""
    idx = [reflect_index(e * (lo - p), e * (hi + p), data.shape[k])
           for k, ((lo, hi), p, e) in enumerate(zip(window, pads, enhance))]
    return data[np.ix_(*idx)]


def crop(hr, window, pads, enhance):
    """The high-res cells of a chunk's own window: drop ``pad *
    enhancement`` cells on both sides of axes 0-2."""
    sl = tuple(slice(p * e, (p + hi - lo) * e)
               for (lo, hi), p, e in zip(window, pads, enhance))
    return hr[sl]


def gan_chunk(model, lr, device):
    """One spatiotemporal model on one padded chunk ``(s1, s2, t, f)``:
    normalise with the model's stats, run the layer list, un-normalise.
    ``model`` is a dict with 'layers', 'params', 'means', 'stdevs'
    (channels-last order) and optional 'exo' rasters by name."""
    x = torch.as_tensor(np.ascontiguousarray(lr), device=device)
    x = (x - model['means']) / model['stdevs']
    x = x.permute(3, 0, 1, 2)[None]
    out = apply(model['layers'], model['params'], x, model.get('exo'))
    out = out[0].permute(1, 2, 3, 0)
    return out * model['out_stdevs'] + model['out_means']


def stats(features, means, stdevs, device):
    """(means, stdevs) float32 tensors of ``features`` in order."""
    m = torch.tensor([means[f] for f in features], dtype=torch.float32,
                     device=device)
    s = torch.tensor([stdevs[f] for f in features], dtype=torch.float32,
                     device=device)
    return m, s
