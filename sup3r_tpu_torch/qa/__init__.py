"""Output QA: re-coarsening error analysis + distribution/spectrum
metrics."""

from sup3r_tpu_torch.qa.qa import Sup3rQa  # noqa: F401
