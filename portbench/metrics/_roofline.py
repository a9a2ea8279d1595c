"""Shared by the kernel roofline readers: the kernel's bound at its
launch shape (``reference.peaks.bound``) over its mean device time a
launch, from the profiled stretch's device events of its name."""

from portbench.reference.peaks import bound


def roofline(record, kind, kernel):
    prof = record.get('profile')
    launch = record.get('small_kernel')
    if record.get('kind') != kind or not prof or launch is None:
        return None
    count, seconds = prof['kernels'].get(kernel, (0, 0.0))
    if not count or seconds <= 0:
        return None
    bound_ms, _, _ = bound(record['device_name'], *launch)
    return 100.0 * bound_ms / (1e3 * seconds / count)
