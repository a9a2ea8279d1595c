"""setup_s: seconds from the start of the run's process to the opening
of its window (imports, inputs, weights, model build, warm-up)."""


def read(record):
    return record.get('setup_s')
