"""FLOP estimation of one call on ``torch.utils.flop_counter``.

The port's copy of ``sup3r_tpu/utilities/flops.py``. The JAX package
walks a function's jaxpr; here ``FlopCounterMode`` counts the aten ops
the call runs, with the same arithmetic: ``2 * prod(out) * k_in *
prod(k_spatial)`` for a convolution and ``2 * b * m * n * k`` for a
matmul (forward and backward ops alike; elementwise work is not
counted).

The port's hand kernels launch through ``ctypes``, which the counter
cannot see. Each kernel wrapper reports the convolution it launches to
``count_kernel_conv`` (reflect-pad-1, k3, stride 1: the output has the
input's spatial shape), so a fused network counts the same on the card
as on the CPU, where the wrappers run their plain PyTorch versions.
What is counted differs from the JAX package only inside its Pallas
kernels: its jaxpr walk counts the ``jnp.dot`` of ``reflect_conv``'s
body once per trace rather than per grid step, and none of
``small_reflect_conv``'s multiply-adds, where the port counts each
kernel's convolution whole.

Used by chip_smoke.py to report achieved TFLOP/s."""

from torch.utils.flop_counter import FlopCounterMode

__all__ = ['estimate_flops']

#: the kernel-FLOP tallies of the ``estimate_flops`` calls in progress
_OPEN = []


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def count_kernel_conv(x_shape, co):
    """Add a hand kernel's launch to every ``estimate_flops`` call in
    progress: a stride-1 'same' 3-wide convolution of a channels-first
    input ``x_shape`` to ``co`` channels (both kernels' reflect-pad-1 k3
    conv)."""
    if not _OPEN:
        return
    n, ci, *spatial = x_shape
    flops = 2 * n * int(co) * _prod(spatial) * int(ci) * 3 ** len(spatial)
    for tally in _OPEN:
        tally[0] += flops


def estimate_flops(fn, *args, **kwargs):
    """Total conv + matmul FLOPs of one call of ``fn(*args, **kwargs)``.
    The call runs (on the device of its inputs)."""
    tally = [0]
    _OPEN.append(tally)
    try:
        with FlopCounterMode(display=False) as mode:
            fn(*args, **kwargs)
    finally:
        _OPEN.remove(tally)
    return int(mode.get_total_flops()) + tally[0]
