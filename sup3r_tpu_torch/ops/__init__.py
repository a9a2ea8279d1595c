"""Ops of the port: the reflect-conv block and the hand-written CUDA
kernels that replace the JAX package's Pallas kernels, plus the array
math the forward pass shares with the data plane (wind rotation,
coarsening, level interpolation, solar position, the device output
pack)."""

from sup3r_tpu_torch.ops.coarsen import (  # noqa: F401
    smooth_data,
    spatial_coarsening,
    spatial_simple_enhancing,
    temporal_coarsening,
    temporal_simple_enhancing,
)
from sup3r_tpu_torch.ops.interp import st_interp  # noqa: F401
from sup3r_tpu_torch.ops.wind import (  # noqa: F401
    invert_uv,
    transform_rotate_wind,
)
