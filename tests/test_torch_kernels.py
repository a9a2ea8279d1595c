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
    ((1, 4, 7, 5, 8), 1),   # the 8 -> 1 tail (gen_3x_4x_1f)
    ((1, 4, 7, 5, 8), 3),   # the 8 -> 3 tail (gen_4x_24x_3f)
    ((1, 3, 2, 33, 8), 2),  # T = 33, not a multiple of a thread's 4 t
    ((2, 2, 2, 6, 8), 2),   # H = W = 2, the smallest that reflects
    ((1, 3, 4, 5, 1), 32),  # ci = 1, co = 32: eight 4-channel groups
    ((1, 3, 4, 5, 32), 1),  # ci = 32, co = 1
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


def _unpack_small(packed, co, ci):
    """Invert ``small_conv_pack_weights``: (weight (co, ci, 3, 3, 3),
    the zero padding)."""
    groups, _, _, g = packed.shape
    cot = min(co, tk.SMALL_CONV_CO_TILE)
    w = packed[..., :3 * cot].reshape(groups, ci, 3, 3, 3, cot)
    w = w.permute(0, 5, 1, 2, 3, 4).reshape(groups * cot, ci, 3, 3, 3)
    return w[:co], w[co:], packed[..., 3 * cot:]


@pytest.mark.parametrize('co,ci', [
    (2, 8),     # the flagship tail
    (1, 8),
    (3, 8),
    (5, 4),     # two groups, the second ragged
    (32, 1),
    (1, 32),
    (14, 32),   # ci * co = 448, near the wrapper's limit
])
def test_small_conv_packed_weights_round_trip(co, ci):
    rng = np.random.default_rng(co * 100 + ci)
    w = torch.from_numpy(rng.standard_normal(
        (co, ci, 3, 3, 3)).astype(np.float32))
    packed = tk.small_conv_pack_weights(w)
    cot = min(co, tk.SMALL_CONV_CO_TILE)
    assert packed.shape == (-(-co // cot), ci, 9, -(-3 * cot // 4) * 4)
    assert packed.shape[-1] % 4 == 0, 'weight groups are read as float4'
    got, pad_co, pad_g = _unpack_small(packed, co, ci)
    torch.testing.assert_close(got, w, rtol=0, atol=0)
    assert not pad_co.any() and not pad_g.any(), 'padding must be zero'


@pytest.mark.parametrize('co,ci', [(2, 8), (3, 8), (5, 4)])
def test_small_conv_packed_taps_compute_the_conv(co, ci):
    """The kernel's reading of the packed weights, in torch: output
    channel ``g * cot + c`` sums ``packed[g, ci, dh * 3 + dw, dt * cot +
    c]`` times the reflect-padded input shifted by (dh, dw, dt)."""
    x, k, b = _inputs(3, (2, 5, 4, 6, ci), co)
    xc, w = (torch.from_numpy(a) for a in (x, k))
    xc, w = xc.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2)
    packed = tk.small_conv_pack_weights(w)
    cot = min(co, tk.SMALL_CONV_CO_TILE)
    xp = torch.nn.functional.pad(xc, (1,) * 6, mode='reflect').double()
    H, W, T = xc.shape[2:]
    y = torch.zeros((2, packed.shape[0] * cot, H, W, T), dtype=torch.float64)
    for dh in range(3):
        for dw in range(3):
            for dt in range(3):
                tap = packed[:, :, dh * 3 + dw, dt * cot:(dt + 1) * cot]
                tap = tap.permute(0, 2, 1).reshape(-1, ci).double()
                shifted = xp[:, :, dh:dh + H, dw:dw + W, dt:dt + T]
                y += torch.einsum('oi,bihwt->bohwt', tap, shifted)
    want = tk.reflect_conv_reference(xc, w, torch.from_numpy(b))
    got = y[:, :co] + torch.from_numpy(b).double()[:, None, None, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
