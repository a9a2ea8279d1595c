"""fwp.prep_ms_per_chunk: ms of host chunk preparation a chunk (the
program's ``ForwardPass.timer`` entry ``get_input_chunk``, summed over
the prep threads, over the pass's chunks), the mean over the window's
passes. Absent where the path logs no such entry."""

import numpy as np


def read(record):
    if record.get('kind') != 'fwp' or not record['prep_s_per_chunk']:
        return None
    return 1e3 * float(np.mean(record['prep_s_per_chunk']))
