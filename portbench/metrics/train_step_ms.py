"""train_step_ms: the window's wall time over the training steps
completed in it, in ms."""


def read(record):
    if record.get('kind') != 'train' or not record['steps']:
        return None
    return 1e3 * record['window_s'] / record['steps']
