"""Published peaks of the card and the bound of one reflect convolution.

Frozen copies of ``PEAKS``, ``peaks`` and ``bound`` from the program's
on-card smoke test (``chip_smoke.py``), so that the yardstick does not
move with the program.
"""

import math

#: (memory bytes/s, fp32 CUDA-core FLOP/s, dense TF32 tensor-core
#: FLOP/s) from NVIDIA's data sheets, by a substring of the card's name;
#: the H100 SXM's when none matches
PEAKS = (('H200', 4.8e12, 67e12, 495e12),
         ('H100 NVL', 3.9e12, 60e12, 417.5e12),
         ('H100 PCIe', 2.0e12, 51e12, 378e12),
         ('H100', 3.35e12, 67e12, 495e12))


def peaks(name):
    """(bytes/s, fp32 FLOP/s, TF32 FLOP/s) of the card called ``name``."""
    for key, *rates in PEAKS:
        if key in name:
            return rates
    return PEAKS[-1][1:]


def fp32_accurate_peak(name):
    """The fastest way to fp32 accuracy on the card: the larger of the
    fp32 rate and the dense TF32 rate over three (3xTF32)."""
    _, fp32, tf32 = peaks(name)
    return max(fp32, tf32 / 3)


def bound(name, x_shape, co, n_weights):
    """(bound_ms, bound_by, peak) of one reflect conv: each input read
    once, the output written once; 2 * taps * ci FLOP per output value.
    The lesser of two ways to do that work in fp32 accuracy: on the
    CUDA cores in fp32, or on the tensor cores as 3xTF32 (three times
    the operations at the dense TF32 rate)."""
    bw, fp32, tf32 = peaks(name)
    n, ci, *spatial = x_shape
    cells = n * math.prod(spatial)
    nbytes = 4 * (cells * ci + cells * co + n_weights + co)
    ops = 2 * cells * co * ci * 3 ** len(spatial)
    t_bytes = nbytes / bw
    t, peak = min((max(t_bytes, ops / fp32), 'fp32'),
                  (max(t_bytes, 3 * ops / tf32), 'tf32x3'))
    return 1e3 * t, 'bytes' if t_bytes >= t else 'operations', peak
