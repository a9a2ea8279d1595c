"""train.gen_grad_ms: device ms a step of the generator loss's gradient,
``autograd.grad`` through the generator and the discriminator (the
program's device span ``train.gen_grad``)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'train', 'device', 'train.gen_grad')
