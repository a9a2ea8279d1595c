"""train.stage_ms: host ms a step of staging the next batch (the
program's span ``batches.stage``: the copies into pinned memory and the
``non_blocking`` copies' enqueue)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'train', 'spans', 'batches.stage')
