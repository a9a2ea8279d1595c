"""Quantile Delta Mapping math (Cannon et al. 2015), vectorized over
space columns.

The port's copy of ``sup3r_tpu/bias/qdm_math.py``: the float64 numpy
host transform as it is, and the device transform in torch (batched
over columns on the tensor's device) in place of the ``jax.vmap`` one.
Empirical CDFs are N quantile x-values per spatial column with quantile
y-values given by a sampling scheme.
"""

import numpy as np
import torch


def sample_q_linear(n):
    """Evenly spaced quantiles including 0 and 1."""
    return np.linspace(0, 1, n)


def sample_q_log(n, log_base=10):
    """Quantiles concentrated near 0."""
    return (log_base ** np.linspace(0, 1, n) - 1) / (log_base - 1)


def sample_q_invlog(n, log_base=10):
    """Quantiles concentrated near 1."""
    return 1 - sample_q_log(n, log_base)[::-1]


def sampled_quantiles(n, sampling='linear', log_base=10):
    """Quantile y-values for the given sampling scheme."""
    sampling = str(sampling).casefold()
    if sampling == 'linear':
        return sample_q_linear(n)
    if sampling == 'log':
        return sample_q_log(n, log_base)
    if sampling == 'invlog':
        return sample_q_invlog(n, log_base)
    raise KeyError(f'Unknown sampling "{sampling}"')


def _interp_to_quantiles(x, xp_cols, quantiles):
    """CDF evaluation: for values ``x`` (T, S) against per-column
    x-values ``xp_cols`` (S, N) with shared ``quantiles`` (N,), return
    tau (T, S) by piecewise-linear interpolation (clipped to [0, 1])."""
    n = xp_cols.shape[-1]
    # count of xp <= x gives right-side index
    idx = np.sum(xp_cols[None, :, :] <= x[:, :, None], axis=-1)
    idx = np.clip(idx, 1, n - 1)
    x0 = np.take_along_axis(xp_cols, (idx - 1).T, axis=-1).T
    x1 = np.take_along_axis(xp_cols, idx.T, axis=-1).T
    q0 = quantiles[idx - 1]
    q1 = quantiles[idx]
    denom = np.where(x1 == x0, 1.0, x1 - x0)
    frac = np.clip((x - x0) / denom, 0, 1)
    return np.clip(q0 + frac * (q1 - q0), 0, 1)


def _interp_from_quantiles(tau, xp_cols, quantiles):
    """Inverse CDF: tau (T, S) -> values from per-column x-values."""
    n = xp_cols.shape[-1]
    idx = np.sum(quantiles[None, None, :] <= tau[:, :, None], axis=-1)
    idx = np.clip(idx, 1, n - 1)
    q0 = quantiles[idx - 1]
    q1 = quantiles[idx]
    x0 = np.take_along_axis(xp_cols, (idx - 1).T, axis=-1).T
    x1 = np.take_along_axis(xp_cols, idx.T, axis=-1).T
    denom = np.where(q1 == q0, 1.0, q1 - q0)
    frac = np.clip((tau - q0) / denom, 0, 1)
    return x0 + frac * (x1 - x0)


class QuantileDeltaMapping:
    """Empirical QDM transform over (time, space) arrays."""

    def __init__(self, params_oh, params_mh, params_mf=None,
                 dist='empirical', relative=True, sampling='linear',
                 log_base=10, delta_denom_min=None,
                 delta_denom_zero=None, delta_range=None):
        """params_*: (space, N) empirical CDF x-values for observed-
        historical, modeled-historical, modeled-future. ``params_mf``
        None (the no-trend case) defaults to ``params_mh``, as rex's
        QuantileDeltaMapping does: the delta term stays, so
        out-of-range values still scale / offset consistently."""
        assert str(dist).casefold() == 'empirical', (
            'Only empirical distributions are implemented')
        self.params_oh = np.asarray(params_oh, dtype=np.float64)
        self.params_mh = np.asarray(params_mh, dtype=np.float64)
        self.params_mf = (self.params_mh if params_mf is None
                          else np.asarray(params_mf, dtype=np.float64))
        self.relative = relative
        self.quantiles = sampled_quantiles(
            self.params_oh.shape[-1], sampling, log_base)
        self.delta_denom_min = delta_denom_min
        self.delta_denom_zero = delta_denom_zero
        self.delta_range = delta_range

    def __call__(self, data):
        """data: (time, space) biased values -> corrected values."""
        data = np.asarray(data, dtype=np.float64)
        tau = _interp_to_quantiles(data, self.params_mf, self.quantiles)
        x_oh = _interp_from_quantiles(tau, self.params_oh,
                                      self.quantiles)
        x_mh = _interp_from_quantiles(tau, self.params_mh,
                                      self.quantiles)
        if self.relative:
            denom = x_mh
            if self.delta_denom_zero is not None:
                denom = np.where(denom == 0, self.delta_denom_zero,
                                 denom)
            if self.delta_denom_min is not None:
                denom = np.maximum(denom, self.delta_denom_min)
            with np.errstate(divide='ignore', invalid='ignore'):
                delta = data / denom
            # non-finite deltas (zero denominators) propagate so the
            # runtime transforms can raise; NaN columns (invalid gids)
            # yield NaN through x_oh either way
            if self.delta_range is not None:
                delta = np.clip(delta, *self.delta_range)
            out = x_oh * delta
        else:
            delta = data - x_mh
            if self.delta_range is not None:
                delta = np.clip(delta, *self.delta_range)
            out = x_oh + delta
        return out.astype(np.float32)


# ----------------------------------------------------------------------
# device (torch) variant: the same piecewise-linear empirical QDM in
# float32, every column in one batched call on the tensor's device.

def _gather_pair(table, idx):
    """``table[..., idx - 1]`` and ``table[..., idx]`` along the last
    axis (``idx`` holds one index row per ``table`` row)."""
    return (torch.gather(table, -1, idx - 1), torch.gather(table, -1, idx))


def _torch_interp_to_quantiles(x, xp, q):
    """CDF evaluation per column: values ``x`` (C, T) against sorted
    x-values ``xp`` (C, N) with quantile y-values ``q`` (N,). A NaN row
    of ``xp`` gives indices that mean nothing, but its gathered x-values
    are NaN, so the row's output is NaN."""
    n = xp.shape[-1]
    idx = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    idx = idx.clamp(1, n - 1)
    x0, x1 = _gather_pair(xp, idx)
    q0, q1 = q[idx - 1], q[idx]
    denom = torch.where(x1 == x0, torch.ones_like(x0), x1 - x0)
    frac = ((x - x0) / denom).clamp(0, 1)
    return (q0 + frac * (q1 - q0)).clamp(0, 1)


def _torch_interp_from_quantiles(tau, xp, q):
    """Inverse CDF per column: tau (C, T) -> values from x-values
    ``xp`` (C, N)."""
    n = xp.shape[-1]
    idx = torch.searchsorted(q, tau.contiguous(), right=True)
    idx = idx.clamp(1, n - 1)
    q0, q1 = q[idx - 1], q[idx]
    x0, x1 = _gather_pair(xp, idx)
    denom = torch.where(q1 == q0, torch.ones_like(q0), q1 - q0)
    frac = ((tau - q0) / denom).clamp(0, 1)
    return x0 + frac * (x1 - x0)


def qdm_transform_device(data, params_oh, params_mh, params_mf,
                         quantiles, relative=True, delta_denom_min=None,
                         delta_denom_zero=None, delta_range=None):
    """QDM of per-column series, batched over columns in torch.

    data: (C, T) biased values; params_*: (C, N) CDF x-values;
    quantiles: (N,). Tensors (or arrays, placed on ``data``'s device).
    Returns the corrected (C, T) float32 tensor on ``data``'s device.
    Mirrors :class:`QuantileDeltaMapping` (host / float64) at fp32
    tolerance; NaN params rows (invalid gids / empty windows) propagate
    to NaN output like the host path."""
    data = torch.as_tensor(data, dtype=torch.float32)
    dev = data.device

    def put(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    oh, mh, mf = put(params_oh), put(params_mh), put(params_mf)
    q = put(quantiles)
    tau = _torch_interp_to_quantiles(data, mf, q)
    x_oh = _torch_interp_from_quantiles(tau, oh, q)
    x_mh = _torch_interp_from_quantiles(tau, mh, q)
    if relative:
        denom = x_mh
        if delta_denom_zero is not None:
            denom = torch.where(denom == 0, put(delta_denom_zero), denom)
        if delta_denom_min is not None:
            denom = torch.maximum(denom, put(delta_denom_min))
        # non-finite deltas propagate (see the host path): NaN columns
        # yield NaN through x_oh either way, and zero denominators must
        # surface loudly
        delta = data / denom
        if delta_range is not None:
            delta = delta.clamp(*delta_range)
        return (x_oh * delta).float()
    delta = data - x_mh
    if delta_range is not None:
        delta = delta.clamp(*delta_range)
    return (x_oh + delta).float()
