"""Shared by the idle readers: one minus the union of the device's busy
intervals over the profiled stretch's length."""


def idle(record, kind):
    prof = record.get('profile')
    if record.get('kind') != kind or not prof or prof['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - prof['busy_s'] / prof['window_s'])
