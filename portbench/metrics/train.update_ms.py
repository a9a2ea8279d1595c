"""train.update_ms: device ms a step of both networks' Adam updates (the
program's device span ``train.update``)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'train', 'device', 'train.update')
