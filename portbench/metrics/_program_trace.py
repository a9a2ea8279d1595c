"""Shared by the readers of the program's own spans and counters: the
``snapshot()`` of ``sup3r_tpu_torch.utilities.trace`` where the run's
process has loaded that module, else None. It never imports the program,
so a program without the module gives no reading.

The program records only while ``torch.profiler`` records, so with
--trace 1 the snapshot holds the profiled stretch alone; each reading is
a mean over the stretch's units: passes (the count of the span
``fwp.run``) or steps (``train.step``)."""

import sys

MODULE = 'sup3r_tpu_torch.utilities.trace'
#: the span that counts a kind's units
UNITS = {'fwp': 'fwp.run', 'train': 'train.step'}


def snapshot():
    module = sys.modules.get(MODULE)
    return None if module is None else module.snapshot()


def per_unit(record, kind, table, name, scale=1e3):
    """``scale`` times the total of ``name`` in the snapshot's ``table``
    (``'spans'`` or ``'device'``: seconds; ``'counts'``: the count) over
    the stretch's units, for a record of ``kind``; None where the
    snapshot, the unit or ``name`` is missing."""
    if record.get('kind') != kind:
        return None
    snap = snapshot()
    if snap is None:
        return None
    units = snap['spans'].get(UNITS[kind], {}).get('count', 0)
    entry = snap[table].get(name)
    if not units or entry is None:
        return None
    return scale * (entry if table == 'counts' else entry['total_s']) / units
