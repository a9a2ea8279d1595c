"""Spatial / temporal coarsening and smoothing (the port of the functions
of ``sup3r_tpu/ops/coarsen.py`` that the derivers and the training
transforms use).

``spatial_coarsening`` and ``temporal_coarsening`` take a numpy array
(the host transform of a batch queue) or a torch tensor (the device
transform of the train step, ``device_transform=True``) and return the
same kind. ``smooth_data`` is host-only (scipy). The simple enhancing
functions come with ``Sup3rCondMom``, their only user.
"""

import numpy as np
import torch
from scipy.ndimage import gaussian_filter

from sup3r_tpu_torch.utilities import not_ported

__getattr__ = not_ported(
    __name__, ('spatial_simple_enhancing', 'temporal_simple_enhancing'),
    'ROADMAP queue 1 item 7, with Sup3rCondMom and its queues (the next '
    'slice)')


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
