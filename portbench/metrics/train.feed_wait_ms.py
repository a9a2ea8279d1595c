"""train.feed_wait_ms: ms a step that the train loop waits on the batch
queue (the program's span ``batches.wait``, around each get, however
short)."""

from portbench.metrics._program_trace import per_unit


def read(record):
    return per_unit(record, 'train', 'spans', 'batches.wait')
