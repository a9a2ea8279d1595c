"""fwp.plan_ms: mean ms of ``ForwardPassStrategy(...)`` a pass (the
benchmark's clock around it): input read or coordinates, the chunk
plan, exogenous rasters, the cached model's lookup."""

import numpy as np


def read(record):
    if record.get('kind') != 'fwp' or not record['plan_s']:
        return None
    return 1e3 * float(np.mean(record['plan_s']))
