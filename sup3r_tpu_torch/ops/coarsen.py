"""Spatial coarsening: the derivers' ``hr_spatial_coarsen``.

Reference parity: sup3r/utilities/utilities.py:406 (spatial_coarsening).
The port's copy of that function of ``sup3r_tpu/ops/coarsen.py``, on
numpy arrays; the training transforms (temporal coarsening, simple
enhancing, smoothing) come with the training slice.
"""

import numpy as np


def spatial_coarsening(data, s_enhance=2, obs_axis=True):
    """Block-mean coarsen the two spatial dims by ``s_enhance``.

    Parameters
    ----------
    data : array
        With ``obs_axis=True``: ``(n_obs, s1, s2, ...)``;
        with ``obs_axis=False``: ``(s1, s2, ...)``. 2D–5D supported.
    s_enhance : int
        Coarsening factor; must evenly divide both spatial dims.
    obs_axis : bool
        Whether axis 0 is an observation/batch axis.
    """
    data = np.asarray(data)
    if s_enhance is None or s_enhance <= 1:
        return data

    ax = 1 if obs_axis else 0
    ndim = data.ndim
    min_dims = 3 if obs_axis else 2
    if ndim < min_dims:
        raise ValueError(
            f'Need >= {min_dims} dims for spatial coarsening with '
            f'obs_axis={obs_axis}, got shape {data.shape}'
        )
    s1, s2 = data.shape[ax], data.shape[ax + 1]
    if s1 % s_enhance or s2 % s_enhance:
        raise ValueError(
            f's_enhance={s_enhance} must evenly divide spatial shape '
            f'({s1}, {s2})'
        )

    lead = data.shape[:ax]
    trail = data.shape[ax + 2:]
    new_shape = (
        *lead, s1 // s_enhance, s_enhance, s2 // s_enhance, s_enhance, *trail
    )
    reshaped = np.reshape(data, new_shape)
    return reshaped.sum(axis=(ax + 1, ax + 3)) / (s_enhance * s_enhance)
