"""fwp_pass_ms_p90: the 90th percentile of the wall times of the
window's passes (node jobs), strategy to outputs on the host, in ms."""

import numpy as np


def read(record):
    if record.get('kind') != 'fwp' or not record['pass_walls_s']:
        return None
    return 1e3 * float(np.percentile(record['pass_walls_s'], 90))
