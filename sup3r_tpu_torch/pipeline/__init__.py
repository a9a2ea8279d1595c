"""Chunked inference pipeline of the port: slicing, planning,
execution."""

from sup3r_tpu_torch.pipeline.slicer import ForwardPassSlicer  # noqa: F401
from sup3r_tpu_torch.pipeline.strategy import (  # noqa: F401
    ForwardPassChunk,
    ForwardPassStrategy,
)
from sup3r_tpu_torch.pipeline.forward_pass import ForwardPass  # noqa: F401
