"""fwp.dispatch_ms: host ms a pass of ``_dispatch_chunk_batch`` (the
program's span ``fwp.dispatch``: stack and pad the batch, normalise and
copy it to the card, enqueue the generator)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'fwp', 'spans', 'fwp.dispatch')
