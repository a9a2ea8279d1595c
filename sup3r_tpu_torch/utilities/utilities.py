"""Host-side utilities the serving path uses: device resolution,
exact-fp32 numerics, timing and JSON serialization (the port's subset of
``sup3r_tpu/utilities/utilities.py``)."""

import contextlib
import json
import time

import numpy as np
import torch


def resolve_device(device):
    """``torch.device`` for an entry point's ``device`` argument.

    A CUDA device with no card raises: the port never drops quietly to
    the CPU. Pass ``device='cpu'`` to run on the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device={str(device)!r} was requested but torch sees no CUDA '
            "device; pass device='cpu' to run on the CPU")
    return device


@contextlib.contextmanager
def exact_fp32():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls inside the
    block, restoring the previous settings after. cuDNN runs fp32
    convolutions in TF32 by default, which keeps about three decimal
    digits; exact mode serves true fp32. The flags are process-wide."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _safe_cast(obj):
    """Cast non-JSON-serializable values for serialization."""
    if isinstance(obj, np.bool_):
        # before np.integer: str(np.False_) == 'False' is TRUTHY on
        # json reload, silently flipping boolean meta flags
        return bool(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (set, tuple)):
        return list(obj)
    if isinstance(obj, slice):
        return [obj.start, obj.stop, obj.step]
    return str(obj)


def safe_serialize(obj, **kwargs):
    """``json.dumps`` tolerant of numpy scalars/arrays and slices."""
    return json.dumps(obj, default=_safe_cast, **kwargs)


class Timer:
    """Interval timer: ``with timer: ...`` sets ``elapsed`` (seconds).
    Host clock only: time device work after ``torch.cuda.synchronize()``.
    """

    def __init__(self):
        self._start = None
        self.elapsed = 0.0

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
