"""Output writing of the port: the chunk-file writers, and the feature
cache (``Cacher`` / ``load_cached``)."""

from sup3r_tpu_torch.postprocessing.cachers import (  # noqa: F401
    Cacher,
    load_cached,
)
from sup3r_tpu_torch.postprocessing.writers import (  # noqa: F401
    OutputHandlerH5,
    OutputHandlerNC,
)
