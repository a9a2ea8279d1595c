"""Host-side utilities of the port: device resolution, exact-fp32
numerics, the seeded RNG, physical output limits, nearest-neighbor NaN
filling, timing and JSON serialization (the port's copy of what it
needs of ``sup3r_tpu/utilities/utilities.py``)."""

import contextlib
import json
import logging
import random
import string
import threading
import time
from warnings import warn

import numpy as np
import torch
from scipy import ndimage

from sup3r_tpu_torch.names import get_feature_basename

logger = logging.getLogger(__name__)


def not_ported(module, names, where):
    """A module ``__getattr__`` that raises ``NotImplementedError``
    naming ``where`` (the ROADMAP item that ports them) for the JAX
    package's ``names`` this module does not have yet."""
    def __getattr__(name):
        if name in names:
            raise NotImplementedError(f'{name} is not ported yet: {where}')
        raise AttributeError(f'module {module!r} has no attribute {name!r}')

    return __getattr__


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


class _LockedGenerator:
    """Thread-safe facade over one seeded ``np.random.Generator``.

    numpy Generators are NOT thread-safe, and batch-queue producer
    pools (``max_workers > 1``) draw sample indices concurrently —
    unserialized draws race on the bit-generator state (duplicated /
    biased indices, lost reproducibility). Draw methods are serialized
    with a lock; draws are microseconds, so the heavy work (window
    reads, coarsening) stays parallel. Single-threaded draw order is
    exactly the bare Generator's (same underlying bit_generator), so
    tests keep reseeding via ``.bit_generator.state``."""

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed=seed)
        self._lock = threading.Lock()

    @property
    def bit_generator(self):
        return self._rng.bit_generator

    def __getattr__(self, name):
        attr = getattr(self._rng, name)
        if not callable(attr):
            return attr

        def locked(*args, **kwargs):
            with self._lock:
                return attr(*args, **kwargs)

        return locked


#: Single, seeded generator used for all host-side sampling so runs are
#: reproducible; tests re-seed it per test.
RANDOM_GENERATOR = _LockedGenerator(seed=42)

#: Physical attributes (storage scale/dtype/limits) for output features.
#: Values match the reference's output_attrs.json so written H5 files are
#: interchangeable.
_WIND_ATTRS = {
    'scale_factor': 100.0,
    'units': 'm s-1',
    'dtype': 'uint16',
    'chunks': (2000, 500),
}
_IRRAD_ATTRS = {
    'scale_factor': 1.0,
    'units': 'W/m2',
    'dtype': 'uint16',
    'chunks': (2000, 500),
    'min': 0,
    'max': 1350,
}
_TEMP_ATTRS = {
    'scale_factor': 100.0,
    'units': 'C',
    'dtype': 'int16',
    'chunks': (2000, 500),
    'min': -200,
    'max': 100,
}
_RH_ATTRS = {
    'scale_factor': 100.0,
    'units': 'percent',
    'dtype': 'uint16',
    'chunks': (2000, 500),
    'min': 0,
    'max': 100,
}

OUTPUT_ATTRS = {
    # the reference's output_attrs.json declares u/v as uint16 with
    # min -120 — a landmine it never steps on because its H5 writer
    # always inverts u/v to ws/wd first. We support invert_uv=False,
    # so u/v must be SIGNED or negative winds wrap to huge positives.
    'u': {**_WIND_ATTRS, 'dtype': 'int16', 'min': -120, 'max': 120},
    'v': {**_WIND_ATTRS, 'dtype': 'int16', 'min': -120, 'max': 120},
    'windspeed': {**_WIND_ATTRS, 'min': 0, 'max': 120},
    'winddirection': {
        **_WIND_ATTRS,
        'units': 'degree',
        'min': 0,
        'max': 360,
    },
    'clearsky_ratio': {
        'scale_factor': 10000.0,
        'units': 'ratio',
        'dtype': 'uint16',
        'chunks': (2000, 500),
        'min': 0,
        'max': 1,
    },
    'dhi': dict(_IRRAD_ATTRS),
    'dni': dict(_IRRAD_ATTRS),
    'ghi': dict(_IRRAD_ATTRS),
    'rsds': dict(_IRRAD_ATTRS),
    'temperature': dict(_TEMP_ATTRS),
    'temperature_min': dict(_TEMP_ATTRS),
    'temperature_max': dict(_TEMP_ATTRS),
    'relativehumidity': dict(_RH_ATTRS),
    'relativehumidity_min': dict(_RH_ATTRS),
    'relativehumidity_max': dict(_RH_ATTRS),
    'pressure': {
        'scale_factor': 0.1,
        'units': 'Pa',
        'dtype': 'uint16',
        'chunks': (2000, 500),
        'min': 0,
        'max': 150000,
    },
    'pr': {
        'scale_factor': 1,
        'units': 'kg m-2 s-1',
        'dtype': 'float32',
        'min': 0,
        'chunks': (2000, 250),
    },
    'srl': {
        'scale_factor': 1,
        'units': 'm',
        'dtype': 'float32',
        'min': 0,
        'chunks': (2000, 250),
    },
}


def generate_random_string(length):
    """Random letter string for collision-free temp file names."""
    return ''.join(random.choice(string.ascii_letters) for _ in range(length))


def get_tmp_file(file):
    """Temporary sibling file name for atomic write-then-rename."""
    tmp = f'{file}.tmp'
    return tmp


def nn_fill_array(array):
    """Replace NaNs with their nearest (euclidean) non-NaN neighbor value.

    Reference parity: sup3r/utilities/utilities.py:55.
    """
    array = np.asarray(array)
    nan_mask = np.isnan(array)
    if not nan_mask.any():
        return array
    indices = ndimage.distance_transform_edt(
        nan_mask, return_distances=False, return_indices=True
    )
    return array[tuple(indices)]


def enforce_limits(features, data, nn_fill=False):
    """Clamp (or NN-fill) each feature channel to its physical limits.

    Parameters
    ----------
    features : list of str
        Names ordered like the last axis of ``data``.
    data : np.ndarray
        ``(..., n_features)`` array, modified and returned as float32.
    nn_fill : bool
        If True, out-of-range values become NaN and are filled from
        nearest valid neighbors instead of clipped.

    Reference parity: sup3r/utilities/utilities.py:155.
    """
    data = np.asarray(data)
    for fidx, name in enumerate(features):
        base = get_feature_basename(name)
        if base not in OUTPUT_ATTRS:
            raise KeyError(f'No known physical limits for feature "{base}"')
        lo = OUTPUT_ATTRS[base].get('min', -np.inf)
        hi = OUTPUT_ATTRS[base].get('max', np.inf)
        channel = data[..., fidx]
        if channel.max() > hi or channel.min() < lo:
            warn(
                f'"{name}" outside physical range ({lo}, {hi}); '
                f'{"nn-filling" if nn_fill else "clipping"}.'
            )
        if nn_fill:
            channel = np.where((channel > hi) | (channel < lo), np.nan,
                               channel)
            data[..., fidx] = nn_fill_array(channel)
        else:
            data[..., fidx] = np.clip(channel, lo, hi)
    return data.astype(np.float32)


def get_dset_attrs(feature):
    """(attrs, dtype) to use when writing ``feature`` to H5."""
    base = get_feature_basename(feature)
    if base in OUTPUT_ATTRS:
        attrs = OUTPUT_ATTRS[base]
        return attrs, attrs.get('dtype', 'float32')
    warn(f'No OUTPUT_ATTRS for "{feature}"; writing float32 unchunked.')
    return {}, 'float32'


class Timer:
    """Accumulating call timer.

    ``timer(fn, log=True)(...)`` or ``with timer: ...``; elapsed times
    accumulate in ``.log`` keyed by function name.

    Host clock only: time device work after ``torch.cuda.synchronize()``.
    """

    def __init__(self):
        self.log = {}
        self._start = None
        self.elapsed = 0.0
        # timed calls run concurrently (ForwardPass prep pool + main
        # dispatch + drain thread share one Timer); the read-add-store
        # on self.log would lose increments without a lock
        self._lock = threading.Lock()

    def start(self):
        """Mark interval start."""
        self._start = time.perf_counter()

    def stop(self):
        """Mark interval end, updating ``elapsed``."""
        self.elapsed = time.perf_counter() - self._start

    @property
    def elapsed_str(self):
        """Human-readable elapsed time."""
        return f'{self.elapsed:.4f} seconds'

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    def __call__(self, func, log=False, call_id=None):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = func(*args, **kwargs)
            dt = time.perf_counter() - t0
            key = f'{func.__name__}' if call_id is None else (
                f'{call_id}_{func.__name__}')
            with self._lock:
                self.log[key] = self.log.get(key, 0.0) + dt
                self.elapsed = dt
            if log:
                logger.debug('Call to %s took %.4f s', func.__name__, dt)
            return out

        return wrapper
