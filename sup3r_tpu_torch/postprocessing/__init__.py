"""Output writing of the port: the chunk-file writers."""

from sup3r_tpu_torch.postprocessing.writers import (  # noqa: F401
    OutputHandlerH5,
    OutputHandlerNC,
)
