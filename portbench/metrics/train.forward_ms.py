"""train.forward_ms: device ms a step of the step's forward: the
generator, both discriminator passes and the losses (the program's
device span ``train.forward``)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'train', 'device', 'train.forward')
