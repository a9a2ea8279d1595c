"""train.disc_grad_ms: device ms a step of the discriminator loss's
gradient (the program's device span ``train.disc_grad``)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'train', 'device', 'train.disc_grad')
