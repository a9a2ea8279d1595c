"""train.wgrad_kernel_pct: the share, in percent, of the stretch's fused
generator blocks' weight gradients that ran on the hand-written
``reflect_conv_wgrad`` kernel (the program's counters
``conv_ad.wgrad_kernel`` and ``conv_ad.wgrad_cudnn``, one a block's weight
gradient by the route it ran); None where the program counts neither."""

from portbench.metrics._program_trace import snapshot


def read(record):
    if record.get('kind') != 'train':
        return None
    snap = snapshot()
    if snap is None:
        return None
    kernel = snap['counts'].get('conv_ad.wgrad_kernel', 0)
    total = kernel + snap['counts'].get('conv_ad.wgrad_cudnn', 0)
    return 100.0 * kernel / total if total else None
