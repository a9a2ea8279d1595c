"""fwp.prep_wait_ms: ms a pass that the main thread waits on chunk
preparation (the program's span ``fwp.prep_wait``, around each prep
future's result)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'fwp', 'spans', 'fwp.prep_wait')
