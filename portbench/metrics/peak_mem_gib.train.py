"""peak_mem_gib.train: ``torch.cuda.max_memory_allocated()`` of the
training run's program (set-up steps and window), in GiB."""


def read(record):
    if record.get('kind') != 'train' or not record['memory_peak_bytes']:
        return None
    return record['memory_peak_bytes'] / 2 ** 30
