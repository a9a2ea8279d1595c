"""Cross-cutting utilities: device resolution, exact fp32, timing."""

from sup3r_tpu_torch.utilities.utilities import (  # noqa: F401
    Timer,
    exact_fp32,
    resolve_device,
    safe_serialize,
)
