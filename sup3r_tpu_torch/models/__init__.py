"""Models of the port: the Sup3rGan serving path and its network."""

from sup3r_tpu_torch.models.gan import Sup3rGan  # noqa: F401
from sup3r_tpu_torch.models.network import Network  # noqa: F401
from sup3r_tpu_torch.models.weights import (  # noqa: F401
    load_jax_checkpoint,
    params_from_jax,
)
