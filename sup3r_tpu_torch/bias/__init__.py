"""Bias calculation (linear/QDM/PresRat) and runtime bias transforms:
the port's copy of ``sup3r_tpu/bias``. The QDM and PresRat calibrations
take their batched percentiles and QDM transform on a torch ``device``
(the card by default); factor files are H5 or NetCDF3."""

from sup3r_tpu_torch.bias.bias_calc import (  # noqa: F401
    LinearCorrection,
    MonthlyLinearCorrection,
    MonthlyScalarCorrection,
    ScalarCorrection,
    SkillAssessment,
)
from sup3r_tpu_torch.bias.qdm import QuantileDeltaMappingCorrection  # noqa
from sup3r_tpu_torch.bias.presrat import PresRat  # noqa: F401
from sup3r_tpu_torch.bias.transforms import (  # noqa: F401
    global_linear_bc,
    local_linear_bc,
    local_presrat_bc,
    local_qdm_bc,
    monthly_local_linear_bc,
)
from sup3r_tpu_torch.bias.bias_calc_vortex import (  # noqa: F401
    BiasCorrectUpdate,
    VortexMeanPrepper,
)
from sup3r_tpu_torch.bias.utilities import lin_bc, qdm_bc  # noqa: F401
