"""Subpixel tail convolution: a k3 reflect conv that follows a spatial
pixel shuffle, computed at the PRE-expansion resolution (the port of
``sup3r_tpu/ops/subpixel.py``, for channels-first tensors).

The flagship generators end with ``SpatioTemporalExpansion(spatial m) ->
LeakyReLU -> FlexiblePadding/Conv/Crop``: a few-channel conv at HR
resolution. With ``x = depth_to_space(z, m)``, HR output pixel ``(m*i+p,
m*j+q)`` reads HR rows ``m*i+p+dh``, which live in LR cell ``i +
(p+dh)//m`` at phase ``(p+dh) % m``. So the tail is ONE k3 conv over
``z`` with a block-sparse ``(m^2*co, m^2*C)`` kernel (the phases
scattered into channel blocks), then a depth_to_space of its ``m^2*co``
outputs. The HR reflect boundary becomes phase-permuted halo cells of
``z`` (HR index -1 reflects to +1, phase 1 of cell 0).

Channel order is TF's ``depth_to_space``: channel ``(p*m+q)*C + c`` of
``z`` holds HR pixel ``(m*i+p, m*j+q)``, channel ``c`` (the port's
``_depth_to_space``, not ``F.pixel_shuffle``). The conv is one
``F.conv3d``, as the JAX version is one XLA conv; it runs in the input's
dtype.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ['build_subpixel_kernel', 'subpixel_tail_conv']


@functools.lru_cache(maxsize=16)
def _subpixel_index(m, ci, co):
    """Flat index into ``[weight.flatten(), 0]`` of every entry of the
    OIDHW block-sparse kernel ``(m*m*co, m*m*ci, 3, 3, 3)``; entries no
    phase reads take the trailing 0. Each (p, dh) pair maps to one
    (cell offset, input phase), so no entry is written twice."""
    zero = co * ci * 27
    idx = np.full((m * m * co, m * m * ci, 3, 3, 3), zero, np.int64)
    src = np.arange(zero).reshape(co, ci, 3, 3, 3)
    for p in range(m):
        for q in range(m):
            ob = (p * m + q) * co
            for dh in (-1, 0, 1):
                di, p_in = divmod(p + dh, m)
                for dw in (-1, 0, 1):
                    dj, q_in = divmod(q + dw, m)
                    ib = (p_in * m + q_in) * ci
                    idx[ob:ob + co, ib:ib + ci, di + 1, dj + 1] = \
                        src[:, :, dh + 1, dw + 1]
    return torch.from_numpy(idx)


def build_subpixel_kernel(weight, m):
    """Scatter an HR OIDHW tail weight ``(co, C, 3, 3, 3)`` into the
    pre-expansion block-sparse weight ``(m*m*co, m*m*C, 3, 3, 3)``. One
    gather from the weight, so gradients reach it."""
    co, ci = weight.shape[:2]
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f'k3 tails only, got weight {tuple(weight.shape)}')
    idx = _subpixel_index(m, ci, co).to(weight.device)
    flat = torch.cat([weight.reshape(-1), weight.new_zeros(1)])
    return flat[idx]


def _phase_reflect_pad(z, m, ci, top=None, bottom=None):
    """Pad ``z`` (n, m*m*ci, S1, S2, T) by one cell on each side of its
    two spatial dims with phase-remapped reflections (the HR reflect-pad-1
    in ``z`` space), and by a plain reflection on time, which carries no
    phase. A halo cell holds the one phase it is read at in every phase
    slot: the others' kernel weights are zero. On a block of s1 rows of a
    spatially sharded ``z``, ``top`` / ``bottom`` are the neighbouring
    ranks' boundary cells (every phase: they are plain neighbours), and
    the reflection applies only at a global edge (None)."""
    n = z.shape[0]

    def phase(cell, dim, k):
        """``cell`` with phase ``k`` of HR axis ``dim`` (1: rows, 2:
        columns) copied into every phase of that axis."""
        blocks = cell.reshape(n, m, m, ci, *cell.shape[2:])
        sel = blocks.narrow(dim, k, 1)
        return torch.cat([sel] * m, dim=dim).reshape(cell.shape)

    # x[-1] = x[1]: phase 1 of the first cell; x[mS] = x[mS-2]: phase
    # m-2 of the last
    top = phase(z[:, :, :1], 1, 1) if top is None else top
    bottom = phase(z[:, :, -1:], 1, m - 2) if bottom is None else bottom
    z = torch.cat([top, z, bottom], dim=2)
    z = torch.cat([phase(z[:, :, :, :1], 2, 1), z,
                   phase(z[:, :, :, -1:], 2, m - 2)], dim=3)
    return torch.cat([z[..., 1:2], z, z[..., -2:-1]], dim=4)


def _leaky(x, alpha):
    """``jax.nn.leaky_relu`` (its gradient at exactly 0 is 1)."""
    return x if alpha is None else torch.where(x >= 0, x, alpha * x)


def subpixel_tail_conv(z, weight, bias, m, alpha_prev=None, alpha=None,
                       halo=(None, None)):
    """LeakyReLU(alpha_prev) -> depth_to_space(m) -> reflect-pad-1 -> k3
    valid conv(weight, bias) -> LeakyReLU(alpha), computed at the
    pre-expansion resolution.

    z: (n, m*m*C, S1, S2, T); weight: (co, C, 3, 3, 3), the HR tail's
    OIDHW weight; bias: (co,). Returns (n, co, m*S1, m*S2, T) in
    ``z``'s dtype. The conv runs at the precision the backend flags set
    (``exact_fp32()`` turns TF32 off). ``halo``: the neighbouring ranks'
    boundary cells of a spatially sharded ``z`` (``_phase_reflect_pad``).
    """
    from sup3r_tpu_torch.models.layers import _depth_to_space

    co, ci = weight.shape[:2]
    if m < 2:
        raise ValueError('subpixel_tail_conv needs a real expansion (m >= '
                         '2); m == 1 is a plain reflect conv')
    if z.shape[1] != m * m * ci:
        raise ValueError(f'z has {z.shape[1]} channels; m={m} and the '
                         f'weight {tuple(weight.shape)} need {m * m * ci}')
    z = _leaky(z, alpha_prev)
    top, bottom = (h if h is None else _leaky(h, alpha_prev) for h in halo)
    kernel = build_subpixel_kernel(weight, m).to(z.dtype)
    y = F.conv3d(_phase_reflect_pad(z, m, ci, top, bottom), kernel,
                 bias.to(z.dtype).repeat(m * m))
    return _leaky(_depth_to_space(y, m), alpha)
