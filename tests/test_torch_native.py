"""The port's native host helpers (``sup3r_tpu_torch._native``) against
the JAX package's (``sup3r_tpu._native``) and against the port's numpy
plain versions, on the cases of tests/utilities/test_native.py.

Bars: the pad and the gather bit-equal to the JAX package's library (the
same C++ on the same inputs); the IDW stencil within 1e-6 relative of
it; the pad bit-equal to ``np.pad``; the gather and the IDW within 1e-6
relative of their numpy forms (the library multiplies by 1 / scale and
sums in its own order). A forward pass with the native pad equals the
pass with ``np.pad`` bit for bit. A failed build raises: there is no
numpy fallback."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import sup3r_tpu._native as jax_native
from sup3r_tpu_torch import _native
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.pipeline import forward_pass as fwp_mod

PADS = [((1, 1), (1, 1), (1, 1)), ((3, 2), (0, 4), (2, 0)),
        ((0, 0), (0, 0), (0, 0))]


def _pad_input():
    return np.random.default_rng(5).random((10, 12, 14, 3)).astype(
        np.float32)


def _gather_inputs(dtype):
    rng = np.random.default_rng(5)
    gids = rng.choice(200, 64, replace=False)
    if dtype == 'uint16':
        return (rng.random((50, 200)) * 2000).astype(np.uint16), gids, 100.0
    return rng.random((50, 200)).astype(np.float32), gids, 2.0


def _idw_inputs():
    rng = np.random.default_rng(5)
    return (rng.random((100, 16)).astype(np.float32),
            rng.integers(0, 100, (40, 4)),
            rng.random((40, 4)).astype(np.float32))


def test_library_builds_into_build_native():
    """The library is built from the port's own source into
    ``build/native/<hash>/`` at the repository root, and loads."""
    assert _native.available() is True
    lib = Path(_native.library_path())
    root = Path(__file__).resolve().parents[1]
    assert lib.exists()
    assert lib.parent.parent == root / 'build' / 'native'
    assert _native.SOURCE.parent == root / 'sup3r_tpu_torch' / '_native'
    assert jax_native.available()


@pytest.mark.parametrize('pads', PADS)
def test_reflect_pad_4d_matches_jax_and_numpy(pads):
    arr = _pad_input()
    got = _native.reflect_pad_4d(arr, pads)
    np.testing.assert_array_equal(got, jax_native.reflect_pad_4d(arr, pads))
    np.testing.assert_array_equal(got, _native.reflect_pad_4d_numpy(arr,
                                                                    pads))
    np.testing.assert_array_equal(
        got, np.pad(arr, (*pads, (0, 0)), mode='reflect'))


@pytest.mark.parametrize('dtype', ['uint16', 'float32'])
def test_gather_scale_transpose_matches_jax_and_numpy(dtype):
    src, gids, scale = _gather_inputs(dtype)
    got = _native.gather_scale_transpose(src, gids, scale=scale)
    assert got.dtype == np.float32 and got.shape == (64, 50)
    np.testing.assert_array_equal(
        got, jax_native.gather_scale_transpose(src, gids, scale=scale))
    np.testing.assert_allclose(
        got, _native.gather_scale_transpose_numpy(src, gids, scale),
        rtol=1e-6, atol=0)


def test_gather_other_dtype_takes_numpy_form():
    """A block the library does not take (int16 here) goes through the
    numpy form, as the JAX package sends it."""
    src, gids, _ = _gather_inputs('uint16')
    src = src.astype(np.int16)
    np.testing.assert_array_equal(
        _native.gather_scale_transpose(src, gids, 10.0),
        jax_native.gather_scale_transpose(src, gids, 10.0))


@pytest.mark.parametrize('trailing', [(16,), (4, 4)])
def test_idw_apply_matches_jax_and_numpy(trailing):
    src, idx, w = _idw_inputs()
    src = src.reshape(100, *trailing)
    got = _native.idw_apply(src, idx, w)
    assert got.shape == (40, *trailing)
    np.testing.assert_allclose(got, jax_native.idw_apply(src, idx, w),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, _native.idw_apply_numpy(src, idx, w),
                               rtol=1e-6, atol=0)


def test_forward_pass_with_native_pad_is_bit_equal(tmp_path, monkeypatch):
    """The chunked pass with the native pad gives the output the pass with
    ``np.pad`` gave before, bit for bit."""
    from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
    from tests.forward_pass.test_forward_pass import (
        _save_model,
        _st_gen_config,
    )

    inp = make_fake_nc_file(str(tmp_path / 'in.nc'), (12, 12, 8),
                            ['u100', 'v100'])
    model_dir, _ = _save_model(str(tmp_path), _st_gen_config(), 3, 4)

    def run():
        return ForwardPass.run(ForwardPassStrategy(
            file_paths=inp, model_kwargs={'model_dir': model_dir,
                                          'device': 'cpu'},
            fwp_chunk_shape=(5, 5, 4), spatial_pad=2, temporal_pad=1,
            out_pattern=None), 0)

    calls = []
    native = fwp_mod.reflect_pad_4d
    monkeypatch.setattr(fwp_mod, 'reflect_pad_4d',
                        lambda a, p: calls.append(p) or native(a, p))
    got = run()
    assert len(calls) == len(got) > 1
    monkeypatch.setattr(fwp_mod, 'reflect_pad_4d',
                        lambda a, p: np.pad(a, (*p, (0, 0)), mode='reflect'))
    want = run()
    assert sorted(got) == sorted(want)
    for idx in want:
        np.testing.assert_array_equal(got[idx], want[idx])


@pytest.mark.parametrize('compiler', ['/nonexistent/g++', 'false'])
def test_failed_build_raises(tmp_path, monkeypatch, compiler):
    """A compiler that is not there, or that fails, makes the build and
    the helpers raise (with what the compiler said), and no library is
    left behind: nothing falls back to numpy."""
    monkeypatch.setattr(_native, 'BUILD_ROOT', tmp_path / 'native')
    monkeypatch.setattr(_native, '_lib', None)
    monkeypatch.setenv('CXX', compiler)
    with pytest.raises(RuntimeError, match='chunk_prep.cpp failed'):
        _native.build()
    with pytest.raises(RuntimeError, match=compiler.split('/')[-1]):
        _native.reflect_pad_4d(_pad_input(), PADS[0])
    with pytest.raises(RuntimeError):
        _native.idw_apply(*_idw_inputs())
    assert not list((tmp_path / 'native').rglob('*.so'))


_RACE = '''
import sys
from pathlib import Path

from sup3r_tpu_torch import _native

_native.BUILD_ROOT = Path(sys.argv[1])
print(_native.build())
'''


def test_ranks_racing_to_build_load_one_library(tmp_path):
    """Three processes building into one empty directory at once each end
    with the same loadable library (each compiles to a name of its own and
    renames it into place)."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    procs = [subprocess.Popen([sys.executable, '-c', _RACE, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True, env=env)
             for _ in range(3)]
    paths = {p.communicate(timeout=120)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    lib, = paths
    assert Path(lib).exists()
    assert [p.name for p in Path(lib).parent.iterdir()] == ['libchunk_prep.so']
    import ctypes

    assert ctypes.CDLL(lib).reflect_pad_4d
