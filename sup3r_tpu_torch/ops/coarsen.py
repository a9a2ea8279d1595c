"""Spatial / temporal coarsening and smoothing (the port of the functions
of ``sup3r_tpu/ops/coarsen.py`` that the derivers and the training
transforms use).

``spatial_coarsening`` and ``temporal_coarsening`` take a numpy array
(the host transform of a batch queue) or a torch tensor (the device
transform of the train step, ``device_transform=True``) and return the
same kind, as do ``spatial_simple_enhancing`` and
``temporal_simple_enhancing`` (the conditional-moment queues' LR
upsampling). ``smooth_data`` is host-only (scipy).
"""

import numpy as np
import torch
from scipy.ndimage import gaussian_filter


def spatial_coarsening(data, s_enhance=2, obs_axis=True):
    """Block-mean coarsen the two spatial dims by ``s_enhance``.

    Parameters
    ----------
    data : np.ndarray | torch.Tensor
        With ``obs_axis=True``: ``(n_obs, s1, s2, ...)``;
        with ``obs_axis=False``: ``(s1, s2, ...)``. 2D–5D supported.
    s_enhance : int
        Coarsening factor; must evenly divide both spatial dims.
    obs_axis : bool
        Whether axis 0 is an observation/batch axis.
    """
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    if s_enhance is None or s_enhance <= 1:
        return data

    ax = 1 if obs_axis else 0
    ndim = data.ndim
    min_dims = 3 if obs_axis else 2
    if ndim < min_dims:
        raise ValueError(
            f'Need >= {min_dims} dims for spatial coarsening with '
            f'obs_axis={obs_axis}, got shape {tuple(data.shape)}'
        )
    s1, s2 = data.shape[ax], data.shape[ax + 1]
    if s1 % s_enhance or s2 % s_enhance:
        raise ValueError(
            f's_enhance={s_enhance} must evenly divide spatial shape '
            f'({s1}, {s2})'
        )

    lead = tuple(data.shape[:ax])
    trail = tuple(data.shape[ax + 2:])
    new_shape = (
        *lead, s1 // s_enhance, s_enhance, s2 // s_enhance, s_enhance, *trail
    )
    reshaped = data.reshape(new_shape)
    if isinstance(data, torch.Tensor):
        return reshaped.sum(dim=(ax + 1, ax + 3)) / (s_enhance * s_enhance)
    return reshaped.sum(axis=(ax + 1, ax + 3)) / (s_enhance * s_enhance)


def temporal_coarsening(data, t_enhance=4, method='subsample'):
    """Coarsen the temporal axis of a 5D ``(n_obs, s1, s2, t, f)`` batch
    (numpy array or torch tensor).

    method : 'subsample' | 'average' | 'total' | 'min' | 'max'
    """
    if t_enhance is None or data.ndim != 5:
        return data
    if method == 'subsample':
        return data[:, :, :, ::t_enhance, :]

    n, s1, s2, t, f = data.shape
    grouped = data.reshape(n, s1, s2, t // t_enhance, t_enhance, f)
    if isinstance(data, torch.Tensor):
        ops = {'average': lambda g: torch.nansum(g, dim=4) / t_enhance,
               'total': lambda g: torch.nansum(g, dim=4),
               'min': lambda g: torch.amin(g, dim=4),
               'max': lambda g: torch.amax(g, dim=4)}
    else:
        ops = {'average': lambda g: np.nansum(g, axis=4) / t_enhance,
               'total': lambda g: np.nansum(g, axis=4),
               'min': lambda g: g.min(axis=4),
               'max': lambda g: g.max(axis=4)}
    if method not in ops:
        raise KeyError(
            f'Unknown temporal_coarsening method "{method}"; options: '
            '[subsample, average, total, min, max]'
        )
    return ops[method](grouped)


def _repeat(data, repeats, axis):
    if isinstance(data, torch.Tensor):
        return torch.repeat_interleave(data, repeats, dim=axis)
    return np.repeat(data, repeats, axis=axis)


def spatial_simple_enhancing(data, s_enhance=2, obs_axis=True):
    """Nearest-neighbor upsample of the spatial dims (repeat each pixel
    ``s_enhance`` times along both spatial axes) of a numpy array or a
    torch tensor.

    Rank validation matches the reference
    (preprocessing/batch_queues/utilities.py:131-141,169-175): <3D always
    rejected; with ``obs_axis=True`` only 4D/5D enhance, with
    ``obs_axis=False`` only 3D/4D.
    """
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    if data.ndim < 3:
        raise ValueError(
            'Data must be 3D, 4D, or 5D to do spatial enhancing, but '
            f'received: {tuple(data.shape)}'
        )
    if s_enhance is None or s_enhance <= 1:
        return data
    ok = data.ndim in ((4, 5) if obs_axis else (3, 4))
    if not ok:
        raise ValueError(
            'Data must be 3D, 4D, or 5D to do spatial enhancing, but '
            f'received: {tuple(data.shape)} (obs_axis={obs_axis})'
        )
    ax = 1 if obs_axis else 0
    return _repeat(_repeat(data, s_enhance, ax), s_enhance, ax + 1)


def temporal_simple_enhancing(data, t_enhance=4, mode='constant'):
    """Upsample the temporal axis of a 5D batch (numpy array or torch
    tensor).

    mode='constant' repeats each step ``t_enhance`` times; mode='linear'
    linearly interpolates onto the enhanced time grid: LR step i anchors
    at HR index i * t_enhance, and the steps past the last anchor
    continue the last segment's slope (the reference's
    batch_queues/utilities.py:40-45 registration). A numpy array takes
    float64 weights, as numpy promotes them; a tensor its own dtype's.

    Non-5D input with an active ``t_enhance`` raises ValueError, matching
    the reference (preprocessing/batch_queues/utilities.py:46-52).
    """
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    if t_enhance is None or t_enhance == 1:
        return data
    if data.ndim != 5:
        raise ValueError(
            'Data must be 5D to do temporal enhancing, but '
            f'received: {tuple(data.shape)}'
        )
    if mode == 'constant':
        return _repeat(data, t_enhance, 3)
    if mode != 'linear':
        raise KeyError(f'Unknown temporal enhancing mode "{mode}"')
    t = data.shape[3]
    pos = np.arange(t * t_enhance) / float(t_enhance)
    lo = np.clip(np.floor(pos).astype(int), 0, t - 1)
    hi = np.clip(lo + 1, 0, t - 1)
    w = (pos - lo)[None, None, None, :, None]
    excess = (pos - (t - 1))[None, None, None, :, None]
    tail = (pos > t - 1)[None, None, None, :, None]
    where = np.where
    if isinstance(data, torch.Tensor):
        w, excess = (torch.as_tensor(v, dtype=data.dtype, device=data.device)
                     for v in (w, excess))
        lo, hi, tail = (torch.as_tensor(v, device=data.device)
                        for v in (lo, hi, tail))
        where = torch.where
    out = data[:, :, :, lo, :] * (1 - w) + data[:, :, :, hi, :] * w
    if t > 1 and bool(tail.any()):
        # past the last anchor hi == lo == t - 1: continue the last
        # segment's slope instead of clamping
        last = data[:, :, :, t - 1:t, :]
        slope = last - data[:, :, :, t - 2:t - 1, :]
        out = where(tail, last + slope * excess, out)
    return out


def smooth_data(low_res, training_features, smoothing_ignore,
                smoothing=None):
    """Gaussian-smooth each spatial slice of a low-res batch (host path).

    Parameters
    ----------
    low_res : np.ndarray
        4D ``(n, s1, s2, f)`` or 5D ``(n, s1, s2, t, f)`` batch.
    training_features : list
        Feature names ordered like the last axis.
    smoothing_ignore : list
        Features to leave unsmoothed (e.g. topography).
    smoothing : float | None
        Gaussian sigma; None is a no-op.
    """
    if smoothing is None:
        return low_res
    # a copy: the writes below must not touch the caller's batch
    low_res = np.array(low_res)
    feat_iter = [
        j for j, f in enumerate(training_features)
        if f not in smoothing_ignore
    ]
    for i in range(low_res.shape[0]):
        for j in feat_iter:
            if low_res.ndim == 5:
                for t in range(low_res.shape[3]):
                    low_res[i, ..., t, j] = gaussian_filter(
                        low_res[i, ..., t, j], smoothing, mode='nearest')
            else:
                low_res[i, ..., j] = gaussian_filter(
                    low_res[i, ..., j], smoothing, mode='nearest')
    return low_res
