"""fwp.generate_device_ms: device ms a pass of the generator's network
and un-normalisation in ``Sup3rGan.generate`` (the program's device span
``model.generate``: CUDA events around the work it enqueues)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'fwp', 'device', 'model.generate')
