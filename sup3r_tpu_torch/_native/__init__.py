"""Native (C++) host-side helpers around the device path (the port of
``sup3r_tpu/_native``): chunk boundary padding (``reflect_pad_4d``, the
forward pass's ``pad_source_data``), the flattened-H5 gather / scale /
transpose (``gather_scale_transpose``) and the IDW regrid stencil
(``idw_apply``, the dual rasterizer's). Each is multithreaded over its
outer dimension with ``std::thread``.

``chunk_prep.cpp`` is the port's own copy of the JAX package's source.
It is compiled at first use with ``g++ -O3 -shared -fPIC -std=c++17
-pthread`` (``$CXX`` overrides the compiler) into
``build/native/<source hash>/`` at the repository root, beside
``ops/build.py``'s ``build/kernels/``, written under a temporary name and
renamed into place (the ranks of a node group race to build it), and
loaded with ctypes. Unlike the JAX package, a failed build raises with
the compiler's output: nothing falls back to numpy in silence. The numpy
forms (``*_numpy``) are the plain versions the tests hold the library
to.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / 'chunk_prep.cpp'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'native'
FLAGS = ('-O3', '-shared', '-fPIC', '-std=c++17', '-pthread')

_LOCK = threading.Lock()
_lib = None


def _compiler():
    return os.environ.get('CXX') or 'g++'


def library_path():
    """Where this source's library lives: ``build/native/<hash of the
    source and flags>/libchunk_prep.so``."""
    h = hashlib.sha256(' '.join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / 'libchunk_prep.so'


def build(force=False):
    """Compile the shared library unless it is there (or ``force``);
    returns its path. Raises RuntimeError with the compiler's output
    when the build fails."""
    lib = library_path()
    if lib.exists() and not force:
        return str(lib)
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f'{lib.stem}.{os.getpid()}.tmp.so')
    cmd = [_compiler(), *FLAGS, str(SOURCE), '-o', str(tmp)]
    logger.info('Building native chunk_prep: %s', ' '.join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(
                f'building {SOURCE.name} failed ({" ".join(cmd)}, exit '
                f'{proc.returncode}):\n{proc.stdout}{proc.stderr}')
        os.replace(tmp, lib)
    except OSError as e:
        raise RuntimeError(f'building {SOURCE.name} failed '
                           f'({" ".join(cmd)}): {e}') from e
    finally:
        if tmp.exists():
            tmp.unlink()
    return str(lib)


def _load():
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i64 = ctypes.c_int64
        f32p = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
        u16p = np.ctypeslib.ndpointer(np.uint16, flags='C_CONTIGUOUS')
        i64p = np.ctypeslib.ndpointer(np.int64, flags='C_CONTIGUOUS')
        lib.reflect_pad_4d.argtypes = [f32p, f32p] + [i64] * 10
        lib.gather_scale_transpose_u16.argtypes = [
            u16p, i64p, f32p, i64, i64, i64, ctypes.c_float]
        lib.gather_scale_transpose_f32.argtypes = [
            f32p, i64p, f32p, i64, i64, i64, ctypes.c_float]
        lib.idw_apply.argtypes = [f32p, i64p, f32p, f32p, i64, i64, i64]
        _lib = lib
        return _lib


def available():
    """Whether the library is built and loaded: True, or the build's
    RuntimeError."""
    return bool(_load())


def reflect_pad_4d_numpy(arr, pad_width):
    """The plain version of ``reflect_pad_4d``."""
    return np.pad(np.asarray(arr, dtype=np.float32), (*pad_width, (0, 0)),
                  mode='reflect')


def reflect_pad_4d(arr, pad_width):
    """``np.pad(arr, (*pad_width, (0, 0)), mode='reflect')`` of a 4D
    (s1, s2, t, f) array as float32, multithreaded."""
    lib = _load()
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    (p1a, p1b), (p2a, p2b), (pta, ptb) = pad_width
    s1, s2, t, f = arr.shape
    out = np.empty((s1 + p1a + p1b, s2 + p2a + p2b, t + pta + ptb, f),
                   dtype=np.float32)
    lib.reflect_pad_4d(arr, out, s1, s2, t, f, p1a, p1b, p2a, p2b,
                       pta, ptb)
    return out


def gather_scale_transpose_numpy(src, gids, scale=1.0):
    """The plain version of ``gather_scale_transpose``."""
    gids = np.asarray(gids, dtype=np.int64)
    return src[:, gids].T.astype(np.float32) / scale


def gather_scale_transpose(src, gids, scale=1.0):
    """A (time, n_sites) block and gid columns -> (n_gids, time) float32
    times 1 / ``scale`` (the flattened-H5 read's hot loop). The library
    takes uint16 and float32 blocks; another dtype takes the numpy form,
    as in the JAX package."""
    if src.dtype not in (np.uint16, np.float32):
        return gather_scale_transpose_numpy(src, gids, scale)
    lib = _load()
    gids = np.ascontiguousarray(gids, dtype=np.int64)
    src = np.ascontiguousarray(src)
    t, n_total = src.shape
    out = np.empty((len(gids), t), dtype=np.float32)
    fn = (lib.gather_scale_transpose_u16 if src.dtype == np.uint16
          else lib.gather_scale_transpose_f32)
    fn(src, gids, out, t, n_total, len(gids), 1.0 / scale)
    return out


def idw_apply_numpy(src, idx, weights):
    """The plain version of ``idw_apply``."""
    weights = np.asarray(weights, np.float32)
    return np.einsum('nk,nk...->n...', weights,
                     np.asarray(src, np.float32)[idx]).astype(np.float32)


def idw_apply(src, idx, weights):
    """``out[n] = sum_k weights[n, k] * src[idx[n, k]]`` over the
    trailing dims, as float32; src (n_src, ...), idx / weights (n_out,
    k)."""
    lib = _load()
    src2 = np.ascontiguousarray(
        np.reshape(src, (src.shape[0], -1)), dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    n_out, k = idx.shape
    out = np.empty((n_out, src2.shape[1]), dtype=np.float32)
    lib.idw_apply(src2, idx, weights, out, n_out, k, src2.shape[1])
    return out.reshape(n_out, *src.shape[1:])
