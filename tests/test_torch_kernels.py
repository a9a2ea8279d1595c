"""The port's two kernel wrappers (``sup3r_tpu_torch/ops/kernels.py``)
against the JAX package's Pallas kernels, run in interpret mode on the
CPU. On CPU tensors the wrappers take their plain PyTorch versions, so
these tests pin the function each CUDA kernel must compute (the kernels
themselves are held against the same plain versions on the card by
chip_smoke.py). Tolerance rtol 1e-5 / atol 1e-6: fp32, the same
arithmetic summed in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sup3r_tpu.ops import pallas_kernels as pk
from sup3r_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def interpret(monkeypatch):
    """Run every ``pl.pallas_call`` in interpret mode, as
    tests/models/test_fuse.py does; counts the calls."""
    orig = pl.pallas_call
    calls = []

    def interp(*a, **kw):
        kw['interpret'] = True
        kw.pop('compiler_params', None)
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(pl, 'pallas_call', interp)
    return calls


def _inputs(seed, x_shape, co):
    """x ~ N(0, 1); kernel ~ N(0, 1 / fan-in), so outputs are O(1)."""
    rng = np.random.default_rng(seed)
    n_spatial = len(x_shape) - 2
    fan_in = 3 ** n_spatial * x_shape[-1]
    x = rng.standard_normal(x_shape).astype(np.float32)
    k = (rng.standard_normal((3,) * n_spatial + (x_shape[-1], co))
         / np.sqrt(fan_in)).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    return x, k, b


def _both(jax_fn, torch_fn, x, k, b, alpha):
    want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                             alpha=alpha))
    got = torch_fn(torch.from_numpy(x), torch.from_numpy(k),
                   torch.from_numpy(b), alpha).numpy()
    return got, want


@pytest.mark.parametrize('alpha', [None, 0.2])
@pytest.mark.parametrize('x_shape,co', [
    ((2, 6, 5, 8, 3), 2),
    ((1, 4, 7, 5, 8), 2),   # the flagship tail's 8 -> 2
    ((2, 3, 2, 9, 4), 5),   # ragged, ci * co = 20
])
def test_small_reflect_conv_matches_pallas(interpret, x_shape, co, alpha):
    x, k, b = _inputs(0, x_shape, co)
    got, want = _both(pk.small_reflect_conv, tk.small_reflect_conv,
                      x, k, b, alpha)
    assert interpret, 'the JAX kernel did not run through pallas_call'
    assert got.shape == want.shape == (*x_shape[:-1], co)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tk.small_reflect_conv_cf.launches == 0


@pytest.mark.parametrize('alpha', [None, 0.2])
@pytest.mark.parametrize('x_shape,co', [
    ((2, 5, 4, 6, 3), 4),
    ((1, 3, 2, 7, 5), 7),
    ((2, 6, 7, 3), 4),      # 2D
    ((1, 5, 2, 6), 3),      # 2D, ragged
])
def test_reflect_conv_matches_pallas(interpret, x_shape, co, alpha):
    x, k, b = _inputs(1, x_shape, co)
    got, want = _both(pk.reflect_conv, tk.reflect_conv, x, k, b, alpha)
    assert interpret, 'the JAX kernel did not run through pallas_call'
    assert got.shape == want.shape == (*x_shape[:-1], co)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert tk.reflect_conv_cf.launches == 0


@pytest.mark.parametrize('fn', [tk.small_reflect_conv, tk.reflect_conv])
def test_requires_grad_raises(fn):
    x, k, b = (torch.from_numpy(a) for a in _inputs(2, (1, 4, 4, 4, 2), 2))
    with pytest.raises(NotImplementedError, match='forward-only'):
        fn(x.requires_grad_(), k, b)
    with torch.no_grad():
        assert fn(x, k, b).shape == (1, 4, 4, 4, 2)


def test_wrappers_reject_mismatched_weights():
    x = torch.zeros(1, 3, 4, 4, 4)
    with pytest.raises(ValueError, match='do not fit'):
        tk.reflect_conv_cf(x, torch.zeros(2, 5, 3, 3, 3), torch.zeros(2))
    with pytest.raises(ValueError, match='expected a 5D input'):
        tk.small_reflect_conv_cf(x[0], torch.zeros(2, 3, 3, 3, 3),
                                 torch.zeros(2))
