"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds). Libraries go to ``build/kernels/<hash>/`` at the
repository root, where ``<hash>`` covers every source and the compiler
flags: a changed source rebuilds, an unchanged one loads. All sources
compile in parallel, one ``nvcc`` process each.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
KERNEL_SOURCES = ('small_reflect_conv', 'reflect_conv', 'reflect_conv_wgrad')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOCK = threading.Lock()
_LIBS = {}
_FUNCTIONS = {}


def _nvcc():
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(path):
        return path
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (looked in $CUDA_HOME/bin and on PATH); the '
            'CUDA kernels are built on the machine with the card')
    return found


def source_hash():
    """Hash of every kernel source and the compiler flags."""
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob('*.cu*')):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_dir():
    """Directory holding this source hash's libraries and build logs."""
    return BUILD_ROOT / source_hash()


def _build(names):
    """Compile the missing libraries of ``names``, one ``nvcc`` process
    per source, all started before any is waited on."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = out_dir / f'lib{name}.so'
        if lib.exists():
            continue
        tmp = out_dir / f'lib{name}.{os.getpid()}.tmp.so'
        with open(out_dir / f'{name}.log', 'w') as log:
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                 str(CSRC_DIR / f'{name}.cu')],
                stdout=log, stderr=subprocess.STDOUT), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        if proc.wait() == 0:
            os.replace(tmp, lib)
        else:
            failed.append((name, (out_dir / f'{name}.log').read_text()))
    if failed:
        raise RuntimeError('nvcc failed:\n' + '\n'.join(
            f'--- {name}\n{text}' for name, text in failed))


def build_all():
    """Build (if needed) and load every kernel library; returns
    ``{name: ctypes.CDLL}``."""
    return _load_many(KERNEL_SOURCES)


def _load_many(names):
    with _LOCK:
        missing = [n for n in names if n not in _LIBS]
        if missing:
            _build(missing)
            for name in missing:
                _LIBS[name] = ctypes.CDLL(
                    str(build_dir() / f'lib{name}.so'))
        return {n: _LIBS[n] for n in names}


def load(name):
    """The loaded library of one kernel source, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _load_many((name,))[name]
    return lib


def c_function(lib_name, fn_name, argtypes):
    """The C entry point ``fn_name`` (arguments ``argtypes``, an int
    error code returned) of ``csrc/<lib_name>.cu``, built and loaded at
    first use."""
    fn = _FUNCTIONS.get(fn_name)
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[fn_name] = fn
    return fn
