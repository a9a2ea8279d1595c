"""fwp.d2h_mb: MB (2 ** 20 bytes) a pass copied from the card to the
host by the drains (the program's counter ``fwp.d2h_bytes``)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'fwp', 'counts', 'fwp.d2h_bytes', 2.0 ** -20)
