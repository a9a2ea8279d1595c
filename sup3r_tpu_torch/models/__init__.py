"""Models of the port: Sup3rGan (serving and training) and its network,
the LinearInterp baseline, MultiStepGan chains, the Sup3rCC solar models
(SolarCC, SolarMultiStepGan), the physics SurfaceSpatialMetModel and its
MultiStepSurfaceMetGan chain, the observation-fused Sup3rGanWithObs, the
data-centric Sup3rGanDC and the conditional-moment Sup3rCondMom."""

from sup3r_tpu_torch.models.conditional import Sup3rCondMom  # noqa: F401
from sup3r_tpu_torch.models.dc import Sup3rGanDC  # noqa: F401
from sup3r_tpu_torch.models.gan import Sup3rGan  # noqa: F401
from sup3r_tpu_torch.models.linear import LinearInterp  # noqa: F401
from sup3r_tpu_torch.models.multi_step import (  # noqa: F401
    MultiStepGan,
    MultiStepSurfaceMetGan,
    SolarMultiStepGan,
)
from sup3r_tpu_torch.models.network import Network  # noqa: F401
from sup3r_tpu_torch.models.solar_cc import SolarCC  # noqa: F401
from sup3r_tpu_torch.models.surface import SurfaceSpatialMetModel  # noqa
from sup3r_tpu_torch.models.weights import (  # noqa: F401
    chain_params_from_jax,
    load_jax_checkpoint,
    params_from_jax,
)
from sup3r_tpu_torch.models.with_obs import Sup3rGanWithObs  # noqa: F401

#: chains whose first step is spatial (the forward pass pads them as the
#: JAX package's ``SPATIAL_FIRST_MODELS`` does)
SPATIAL_FIRST_MODELS = (MultiStepSurfaceMetGan, SolarMultiStepGan)
