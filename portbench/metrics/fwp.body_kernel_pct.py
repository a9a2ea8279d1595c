"""fwp.body_kernel_pct: the share, in percent, of the stretch's fused
generator blocks that the small tail kernel does not take which ran on
the hand-written ``reflect_conv`` kernel (the program's counters
``fuse.body_kernel`` and ``fuse.body_cudnn``, one a block by the route it
ran); None where the program counts neither."""

from portbench.metrics._program_trace import snapshot


def read(record):
    if record.get('kind') != 'fwp':
        return None
    snap = snapshot()
    if snap is None:
        return None
    kernel = snap['counts'].get('fuse.body_kernel', 0)
    total = kernel + snap['counts'].get('fuse.body_cudnn', 0)
    return 100.0 * kernel / total if total else None
