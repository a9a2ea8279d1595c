"""fwp.drain_ms: ms a pass of ``_drain_chunk_batch`` on the drain thread
(the program's span ``fwp.drain``: crops, the copy to the host, which
waits for the batch's kernels, the output check, writes)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'fwp', 'spans', 'fwp.drain')
