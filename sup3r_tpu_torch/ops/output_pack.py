"""Device-side output packing: u/v inversion + physical limits +
integer quantization on the cropped chunk batch, in torch on the
output's device, so the device->host fetch carries cropped
int16/uint16 bytes instead of the full padded float32 block (the port
of ``sup3r_tpu/ops/output_pack.py``, whose version is a jitted XLA
program; this one is plain torch, not a hand-written kernel).

Why this exists: in the chunked inference drain, the device->host
transfer over PCIe is a large cost, and the reference
pipeline's output transform (u/v -> ws/wd rotation, limit clipping,
``round(x * scale_factor).astype(int16)``; reference
sup3r/postprocessing/writers/base.py:232-346 +
sup3r/utilities/utilities.py:155) runs per pixel on the host CPU.
Both costs shrink together by packing ON DEVICE: the fetch moves
2 bytes/voxel of already-final storage values (>=2x fewer bytes, plus
the halo crop), and the host writer only hands buffers to h5py.

Parity notes:
- The rotation reuses :func:`sup3r_tpu_torch.ops.wind.invert_uv_core`
  — the SAME formula as the host path — with the grid angle computed on
  host by the SAME ``_grid_angle`` numpy code, so only the trig/rounding
  ulps differ. Post-quantization that shows up as occasional +-1
  STORAGE QUANTUM flips at round() boundaries (tested bound).
- Quantization mirrors ``np.round(x * scale).astype(dtype)`` including
  the two's-complement wraparound an out-of-range C cast produces
  (explicit modular arithmetic, exact because values are wrapped
  in-range BEFORE the dtype conversion). ``torch.round`` rounds half to
  even like numpy, and ``torch.remainder`` is the floor mod
  (``torch.fmod`` would truncate).
- Unknown features raise the same KeyError as ``enforce_limits``.
"""

import numpy as np
import torch

from sup3r_tpu_torch.names import uv_height_pairs
from sup3r_tpu_torch.ops._dispatch import torch_numpy
from sup3r_tpu_torch.ops.wind import _grid_angle, invert_uv_core
from sup3r_tpu_torch.utilities.utilities import (
    OUTPUT_ATTRS,
    get_feature_basename,
)

__all__ = ['fetch_stats', 'pack_chunks', 'pack_plan', 'theta_for']

#: torch dtypes of the storage dtypes
_STORAGE = {'int16': torch.int16, 'uint16': torch.uint16}


def pack_plan(features, invert_uv):
    """Resolve the static (hashable) pack plan on host.

    Returns ``(names, pairs, quant)``: the final storage feature names
    after u/v inversion, the (u_idx, v_idx) channel pairs to rotate,
    and per-feature quantization specs ``(dtype, scale, lo, hi)``.
    Raises KeyError for features without OUTPUT_ATTRS — the same error
    the host path's ``enforce_limits`` raises."""
    feats = [str(f) for f in features]
    names = list(feats)
    pairs = []
    if invert_uv:
        for h, ui, vi in uv_height_pairs(feats):
            pairs.append((ui, vi))
            names[ui] = f'windspeed_{h}m'
            names[vi] = f'winddirection_{h}m'
    quant = []
    for name in names:
        base = get_feature_basename(name)
        if base not in OUTPUT_ATTRS:
            raise KeyError(
                f'No known physical limits for feature "{base}"')
        a = OUTPUT_ATTRS[base]
        quant.append((str(a.get('dtype', 'float32')),
                      float(a.get('scale_factor', 1.0)),
                      float(a.get('min', -np.inf)),
                      float(a.get('max', np.inf))))
    return tuple(names), tuple(pairs), tuple(quant)


def theta_for(lat_lon, invert_lat):
    """Grid angle for one chunk's HR lat_lon, host-computed by the
    same ``_grid_angle`` code the host inversion uses (identical
    values), on orientation-flipped coords when ``invert_lat``."""
    ll = np.asarray(lat_lon, dtype=np.float32)
    if invert_lat:
        ll = ll[::-1]
    return np.asarray(_grid_angle(ll, np), dtype=np.float32)


def _quantize(x, dtype_name, scale):
    """Mirror ``np.round(x * scale).astype(dtype)`` for integer
    storage dtypes, with the out-of-range wraparound made explicit
    (modular shift into the dtype's range, then an exact in-range
    conversion)."""
    if dtype_name == 'float32':
        return x
    info = np.iinfo(np.dtype(dtype_name))
    span = float(info.max) - float(info.min) + 1.0
    v = torch.round(x * scale)
    v = torch.remainder(v - float(info.min), span) + float(info.min)
    # via int32: torch's uint16 has few ops, but takes this cast
    return v.to(torch.int32).to(_STORAGE[dtype_name])


def pack_chunks(out, theta, pairs, quant, invert_lat):
    """out: (n, s1, s2, t, f) cropped model output (model units), a
    tensor on any device; theta: (n, s1, s2) on the same device.
    Returns (packed, stats): per-feature (n, t, s1*s2) storage tensors
    in writer layout, plus the output-check statistics computed
    on the PRE-transform data: ``nan_any`` (n,), ``ch_const``,
    ``ch_first``, ``ch_min`` and ``ch_max`` (n, f), all on the device.
    Runs under ``torch.inference_mode``; ``out`` is not modified."""
    with torch.inference_mode():
        n, s1, s2, t, f = out.shape
        flat = out.reshape(n, -1, f)
        stats = {
            'nan_any': torch.isnan(flat).any(dim=2).any(dim=1),
            'ch_const': torch.all(flat == flat[:, :1, :], dim=1),
            'ch_first': flat[:, 0, :],
        }
        chans = [out[..., i] for i in range(f)]
        th = theta[..., None]
        for ui, vi in pairs:
            ws, wd = invert_uv_core(chans[ui], chans[vi], th, invert_lat,
                                    torch_numpy, s_axis=1)
            chans[ui], chans[vi] = ws, wd
        packed, mins, maxs = [], [], []
        for i, (dt, scale, lo, hi) in enumerate(quant):
            x = chans[i]
            mins.append(x.amin(dim=(1, 2, 3)))
            maxs.append(x.amax(dim=(1, 2, 3)))
            x = torch.clamp(x, lo, hi)
            # writer layout (sites flattened row-major, time leading):
            # data[..., i].reshape(s1*s2, t).T done on device
            x = x.permute(0, 3, 1, 2).reshape(n, t, s1 * s2)
            packed.append(_quantize(x, dt, scale))
        stats['ch_min'] = torch.stack(mins, dim=-1)
        stats['ch_max'] = torch.stack(maxs, dim=-1)
    return tuple(packed), stats


def fetch_stats(stats):
    """The stats dict as numpy arrays through ONE device-to-host copy:
    every entry is cast to float32 (exact for the flags and for the
    float32 values) and concatenated on the device."""
    n = stats['nan_any'].shape[0]
    keys = ('nan_any', 'ch_const', 'ch_first', 'ch_min', 'ch_max')
    parts = [stats[k].reshape(n, -1).to(torch.float32) for k in keys]
    host = torch.cat(parts, dim=1).cpu().numpy()
    out, col = {}, 0
    for k, p in zip(keys, parts):
        block = host[:, col:col + p.shape[1]]
        col += p.shape[1]
        if k == 'nan_any':
            block = block[:, 0]
        out[k] = block.astype(bool) if k in ('nan_any', 'ch_const') \
            else block
    return out
