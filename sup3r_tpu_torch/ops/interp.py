"""Spatiotemporal and vertical-level interpolation.

Reference parity: sup3r/models/utilities.py:161 (st_interp),
sup3r/utilities/interpolation.py:17-233 (Interpolator: level masks,
linear/log vertical interpolation). The port's copy of
``sup3r_tpu/ops/interp.py``: ``st_interp`` in torch on the tensor's
device (``LinearInterp`` serves with it), the vertical interpolation of
the derivers' level features on numpy arrays.
"""

import numpy as np
import torch


def _axis_points(n, offset=True):
    """Cell-centered sample positions of n points in a (0, 10) span,
    built as ``arange(n) * (10/n)`` (``np.arange(0, 10, 10/n)`` returns
    n+1 points when 10/n rounds down)."""
    pts = np.arange(n) * (10 / n)
    return pts + 5 / n if offset else pts


def _interp1d_weights(src, dst):
    """For each dst position (lo_idx, hi_idx, alpha) of linear
    interpolation, with linear extrapolation beyond the src endpoints."""
    lo = np.clip(np.searchsorted(src, dst) - 1, 0, len(src) - 2)
    hi = lo + 1
    return lo, hi, (dst - src[lo]) / (src[hi] - src[lo])


def _lerp_axis(x, lo, hi, alpha, axis):
    """Gather-and-lerp one axis of a tensor onto (lo, hi, alpha)."""
    dev = x.device
    a_lo = x.index_select(axis, torch.as_tensor(lo, device=dev))
    a_hi = x.index_select(axis, torch.as_tensor(hi, device=dev))
    shape = [1] * x.ndim
    shape[axis] = -1
    w = torch.as_tensor(alpha, dtype=x.dtype, device=dev).reshape(shape)
    return a_lo * (1 - w) + a_hi * w


def st_interp_axes(x, s_enhance, t_enhance, t_centered=False,
                   axes=(0, 1, 2)):
    """``st_interp`` over the (s1, s2, t) ``axes`` of a tensor of any
    rank (e.g. a (n, s1, s2, t, f) batch in one pass)."""
    shape = [x.shape[a] for a in axes]
    assert all(s > 1 for s in shape), \
        'st_interp input cannot have axes of length 1'
    out = x
    for axis, n, en, offset in zip(axes, shape,
                                   (s_enhance, s_enhance, t_enhance),
                                   (True, True, t_centered)):
        lo, hi, alpha = _interp1d_weights(_axis_points(n, offset),
                                          _axis_points(n * en, offset))
        out = _lerp_axis(out, lo, hi, alpha, axis)
    return out


def st_interp(low, s_enhance, t_enhance, t_centered=False):
    """Tri-linear spatiotemporal interpolation of a ``(s1, s2, t)``
    field onto the enhanced grid, with cell-centered spatial registration
    and linear extrapolation at the edges (the reference's
    RegularGridInterpolator-with-extrapolation baseline, built from
    separable gather + lerp). A tensor stays on its device; a numpy
    array runs on the CPU. Returns a tensor."""
    low = torch.as_tensor(low)
    assert low.ndim == 3, 'st_interp input must be 3D (s1, s2, t)'
    return st_interp_axes(low, s_enhance, t_enhance, t_centered)



def get_level_masks(lev_array, level):
    """Boolean masks picking, per (..., level) column, the closest level
    below and the closest level above the requested ``level``. Falls back
    to the two overall-closest levels when one side has no candidates.

    lev_array : ``(..., n_levels)`` array of level values (height or
    pressure), potentially varying per grid point / time.
    """
    lev_array = np.asarray(lev_array)
    n_lev = lev_array.shape[-1]
    idx = np.arange(n_lev)
    idx = np.broadcast_to(idx, lev_array.shape)

    finite = ~np.isnan(lev_array)
    above = (lev_array >= level) & finite
    below = (lev_array < level) & finite
    big = np.asarray(np.inf, dtype=lev_array.dtype)

    # NaN level entries (e.g. below-surface ERA5 heights) are treated
    # as unavailable candidates, like the reference's masked arrays
    # (sup3r/utilities/interpolation.py get_level_masks)
    dist = np.where(finite, np.abs(lev_array - level), big)
    dist_below = np.where(below, dist, big)
    dist_above = np.where(above, dist, big)

    argmin_below = np.argmin(dist_below, axis=-1, keepdims=True)
    argmin_above = np.argmin(dist_above, axis=-1, keepdims=True)
    mask1 = idx == argmin_below
    mask2 = idx == argmin_above

    argmin_any = np.argmin(dist, axis=-1, keepdims=True)
    below_exists = below.any(axis=-1, keepdims=True)
    mask1 = np.where(below_exists, mask1, idx == argmin_any)

    above_exists = above.any(axis=-1, keepdims=True)
    dist_alt = np.where(mask1, big, dist)
    argmin_alt = np.argmin(dist_alt, axis=-1, keepdims=True)
    mask2 = np.where(above_exists, mask2, idx == argmin_alt)
    return mask1, mask2


def _lin_vertical(lev0, lev1, var0, var1, level):
    diff = lev1 - lev0
    alpha = np.where(np.abs(diff) < 1e-3, 0.0, (level - lev0) / diff)
    return var0 * (1 - alpha) + var1 * alpha


def _log_vertical(lev0, lev1, var0, var1, level):
    """Fit a*log(h - h0 + 1) + v0 through the two samples, then evaluate.
    Used for near-surface wind profiles."""
    swap = lev0 >= lev1
    h0 = np.where(swap, lev1, lev0)
    h1 = np.where(swap, lev0, lev1)
    v0 = np.where(swap, var1, var0)
    v1 = np.where(swap, var0, var1)
    coeff = np.where(h1 == h0, 0.0, (v1 - v0) / np.log1p(h1 - h0))
    coeff = np.where(level < h0, -coeff, coeff)
    return coeff * np.log1p(np.abs(level - h0)) + v0


def interp_to_level(lev_array, var_array, level, method='linear'):
    """Interpolate ``var_array`` to a fixed ``level`` along the last axis.

    lev_array, var_array : ``(..., n_levels)`` arrays; lev gives the
    height/pressure value of each var entry. Returns ``(...)`` array.
    method : 'linear' | 'log'
    """
    import warnings

    lev_array = np.asarray(lev_array)
    if np.isnan(lev_array).any():
        # reference behavior: interpolate past NaN levels with a
        # warning (interpolation.py docstring: 'Data will be
        # interpolated or extrapolated past these NaN values')
        warnings.warn('lev_array contains NaN values; interpolating '
                      'past them')
    mask1, mask2 = get_level_masks(lev_array, level)
    lev0 = np.sum(np.where(mask1, lev_array, 0), axis=-1)
    lev1 = np.sum(np.where(mask2, lev_array, 0), axis=-1)
    var0 = np.sum(np.where(mask1, var_array, 0), axis=-1)
    var1 = np.sum(np.where(mask2, var_array, 0), axis=-1)
    if method == 'log':
        return _log_vertical(lev0, lev1, var0, var1, level)
    return _lin_vertical(lev0, lev1, var0, var1, level)
