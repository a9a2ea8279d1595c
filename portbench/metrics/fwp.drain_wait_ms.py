"""fwp.drain_wait_ms: ms a pass that the main thread waits on the drains
after its last dispatch (the program's span ``fwp.drain_wait``)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'fwp', 'spans', 'fwp.drain_wait')
