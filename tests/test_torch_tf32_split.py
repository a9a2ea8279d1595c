"""The numerics the port's tensor-core ``reflect_conv`` kernel
(``sup3r_tpu_torch/csrc/reflect_conv.cu``) relies on, pinned on the CPU:
the wrapper's TF32 split of the weights, the kernel-order weight layout
(``pack_weights``), and a 3xTF32 reflect conv emulated in torch against
the float64 conv. Inputs are numpy-seeded."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sup3r_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

#: the kernels' bar against their plain version (chip_smoke.py)
KERNEL_RTOL = 1e-5


def _rna_tf32(v):
    """Independent float64 reference of PTX ``cvt.rna.tf32.f32``: round
    to 11 significant bits, to nearest, ties away from zero."""
    m, e = np.frexp(v.astype(np.float64))       # v = m * 2**e, |m| in [0.5, 1)
    scaled = np.abs(m) * 2.0 ** 11
    r = np.floor(scaled + 0.5)                  # ties go up in magnitude
    return (np.sign(m) * r * 2.0 ** (e - 11)).astype(np.float32)


def _values(seed, n=4096):
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n))
    v = v.astype(np.float32)
    # exact ties: 11 significant bits plus exactly half a TF32 ulp
    ties = (rng.integers(1024, 2048, 64) * 2.0 + 1.0) * 2.0 ** -12
    signs = rng.choice([-1.0, 1.0], 64)
    return np.concatenate([v, (ties * signs).astype(np.float32)])


def test_split_hi_clears_low_mantissa_and_rounds_nearest_ties_away():
    v = _values(0)
    hi, lo = tk.split_tf32(torch.from_numpy(v))
    bits = hi.numpy().view(np.int32)
    assert not (bits & 0x1FFF).any(), 'hi keeps bits below TF32 precision'
    assert not (lo.numpy().view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi.numpy(), _rna_tf32(v))
    ties = v[-64:]
    assert (np.abs(hi.numpy()[-64:]) > np.abs(ties)).all(), \
        'ties must round away from zero'


def test_split_rebuilds_to_2_pow_minus_22():
    v = _values(1)
    hi, lo = tk.split_tf32(torch.from_numpy(v))
    rebuilt = hi.double().numpy() + lo.double().numpy()
    rel = np.abs(rebuilt - v) / np.abs(v)
    assert rel.max() <= 2.0 ** -22


def _unpack(packed, co, ci, n_spatial):
    """Invert ``pack_weights``: (hi, lo), each (co, ci, [3,] 3, 3)."""
    n_tiles, chunks, k0, taps, _, halves, n_tile, k4 = packed.shape
    w = packed.permute(4, 0, 6, 1, 5, 7, 2, 3).reshape(
        2, n_tiles * n_tile, chunks * halves * k4, k0, taps)
    w = w.reshape(2, n_tiles * n_tile, chunks * halves * k4,
                  *(3,) * n_spatial)
    return w[:, :co, :ci], w[:, co:], w[:, :, ci:]


@pytest.mark.parametrize('co,ci,n_spatial', [
    (64, 64, 3),    # the flagship's body convs
    (72, 64, 3),    # the 64 -> 72 conv before the pixel shuffle
    (64, 2, 3),     # the first conv, ci = 2
    (130, 5, 2),    # 2D, two N tiles, ragged channels
])
def test_packed_weights_round_trip(co, ci, n_spatial):
    rng = np.random.default_rng(co * 1000 + ci)
    w = torch.from_numpy(rng.standard_normal(
        (co, ci) + (3,) * n_spatial).astype(np.float32))
    n_tile = tk.reflect_conv_n_tile(co)
    packed = tk.pack_weights(w, n_tile)
    assert packed.shape == (-(-co // n_tile), -(-ci // 8),
                            3 if n_spatial == 3 else 1, 9, 2, 2, n_tile, 4)
    (hi, lo), pad_co, pad_ci = _unpack(packed, co, ci, n_spatial)
    want_hi, want_lo = tk.split_tf32(w)
    torch.testing.assert_close(hi, want_hi, rtol=0, atol=0)
    torch.testing.assert_close(lo, want_lo, rtol=0, atol=0)
    assert not pad_co.any() and not pad_ci.any(), 'padding must be zero'


def test_n_tile_holds_co_in_one_tile_up_to_128():
    assert [tk.reflect_conv_n_tile(c) for c in (2, 32, 33, 64, 70, 72, 73,
                                                128, 256)] == [
        32, 32, 64, 64, 72, 72, 128, 128, 128]


def _reflect_conv64(x, w):
    n = x.ndim - 2
    conv = F.conv3d if n == 3 else F.conv2d
    return conv(F.pad(x, (1,) * (2 * n), mode='reflect'), w)


def test_emulated_3xtf32_conv_within_kernel_bar():
    """hi*hi + hi*lo + lo*hi, each product exact in float64, summed in
    float32, stays within 1e-5 of max against the float64 conv at the
    flagship's widest conv (ci 64 -> co 72, 27 taps)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 64, 4, 5, 6)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((72, 64, 3, 3, 3))
                          / np.sqrt(64 * 27)).astype(np.float32))
    xh, xl = (t.double() for t in tk.split_tf32(x))
    wh, wl = (t.double() for t in tk.split_tf32(w))
    terms = [_reflect_conv64(a, b).float()
             for a, b in ((xl, wh), (xh, wl), (xh, wh))]
    got = (terms[0] + terms[1]) + terms[2]
    want = _reflect_conv64(x.double(), w.double())
    err = (got.double() - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= KERNEL_RTOL * scale
    # one TF32 pass alone is far outside the bar: the split is needed
    one_pass = (_reflect_conv64(xh, wh) - want).abs().max().item()
    assert one_pass > 10 * KERNEL_RTOL * scale
