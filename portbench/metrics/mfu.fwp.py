"""mfu.fwp: the forward pass's model operations (each member's layer
list at the padded chunk shapes, times the chunks done) a second of the
window, as a share of the card's fp32-accurate peak."""

from portbench.metrics._mfu import mfu


def read(record):
    return mfu(record, 'fwp')
