"""Models of the port: Sup3rGan (serving and training) and its network."""

from sup3r_tpu_torch.models.gan import Sup3rGan  # noqa: F401
from sup3r_tpu_torch.models.network import Network  # noqa: F401
from sup3r_tpu_torch.models.weights import (  # noqa: F401
    load_jax_checkpoint,
    params_from_jax,
)
from sup3r_tpu_torch.utilities import not_ported

__getattr__ = not_ported(
    __name__, ('Sup3rCondMom', 'Sup3rGanDC', 'LinearInterp', 'MultiStepGan',
               'MultiStepSurfaceMetGan', 'SolarMultiStepGan', 'SolarCC',
               'SurfaceSpatialMetModel', 'Sup3rGanWithObs'),
    'ROADMAP queue 1 item 7, the model family and its train steps')
