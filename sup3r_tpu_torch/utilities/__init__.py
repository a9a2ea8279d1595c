"""Cross-cutting utilities: device resolution, exact fp32, timing, the
seeded RNG, output limits and a pandas-free time index."""

from sup3r_tpu_torch.utilities.utilities import (  # noqa: F401
    OUTPUT_ATTRS,
    RANDOM_GENERATOR,
    Timer,
    enforce_limits,
    exact_fp32,
    generate_random_string,
    get_dset_attrs,
    get_tmp_file,
    nn_fill_array,
    not_ported,
    resolve_device,
    safe_serialize,
)
from sup3r_tpu_torch.utilities.times import TimeIndex  # noqa: F401

#: the phygnn checkpoint import (``sup3r_tpu/utilities/port.py``)
__getattr__ = not_ported(
    __name__, ('port',),
    'ROADMAP queue 1 item 7, after Sup3rCondMom (the next slice)')
