"""Cross-cutting utilities: device resolution, exact fp32, timing, the
seeded RNG, output limits and a pandas-free time index. ``port`` imports
the reference's phygnn / TensorFlow checkpoints."""

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
    resolve_device,
    safe_serialize,
)
from sup3r_tpu_torch.utilities.times import TimeIndex  # noqa: F401


def load_reference_gan(model_dir, **kwargs):
    """Import a reference (NREL sup3r / phygnn TF) model checkpoint
    directory into a ``Sup3rGan`` (lazy import; see utilities/port.py)."""
    from sup3r_tpu_torch.utilities.port import load_reference_gan as _load

    return _load(model_dir, **kwargs)
