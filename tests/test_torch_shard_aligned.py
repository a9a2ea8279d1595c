"""The port's shard-aligned s1 conv (``ops/conv_ad.py``:
``reflect_conv_shard_aligned`` and its custom backward) against the JAX
package's (tests/forward_pass/test_shard_aligned_conv.py), the sharded
route's halo conv (``reflect_conv_halo``) on blocks of rows against the
unsplit conv, and the whole flagship generator with
``inference_shard_aligned`` on and off, the fused-apply cache keeping
both.

Bars: the forward at rtol 1e-5, atol 1e-6 of JAX's; the gradients within
1e-5 of each gradient's largest magnitude of JAX's custom VJP (and 2e-5
of the port's own forward's autograd); the halo conv's rows within 1e-6
of the unsplit conv's; the flagship within 1e-4 of the default route and of the
JAX package's shard-aligned generate (fp32 reassociation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sup3r_tpu.configs import get_config
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.ops.conv_ad import (
    reflect_conv_shard_aligned as jax_shard_aligned,
)
from sup3r_tpu_torch.models import Sup3rGan, params_from_jax
from sup3r_tpu_torch.models.fuse import FusedReflectConv
from sup3r_tpu_torch.ops.conv_ad import (
    _sa_forward,
    reflect_conv_ad,
    reflect_conv_halo,
    reflect_conv_shard_aligned,
    shard_aligned_worthwhile,
)

torch.set_num_threads(1)

CASES = [(3, (2, 8, 6, 5, 4)), (2, (3, 9, 7, 4))]


def _inputs(n_spatial, shape, seed):
    """(x, kernel, bias, cotangent) channels-last numpy, as the JAX test
    draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3,) * n_spatial + (shape[-1], 6))
         * 0.1).astype(np.float32)
    b = (rng.standard_normal(6) * 0.1).astype(np.float32)
    cot = rng.standard_normal(shape[:-1] + (6,)).astype(np.float32)
    return x, k, b, cot


def _cf(a):
    """Channels-last numpy -> channels-first tensor."""
    return torch.from_numpy(a).movedim(-1, 1).contiguous()


def _weight(k, n_spatial):
    """A (..., ci, co) JAX kernel -> the port's (co, ci, ...) weight."""
    return torch.from_numpy(k).permute(
        n_spatial + 1, n_spatial, *range(n_spatial)).contiguous()


@pytest.mark.parametrize('n_spatial,shape', CASES)
@pytest.mark.parametrize('alpha', [None, 0.2])
def test_shard_aligned_matches_reflect(n_spatial, shape, alpha):
    x, k, b, _ = _inputs(n_spatial, shape, 0)
    want = np.asarray(jax_shard_aligned(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), n_spatial, alpha))
    w = _weight(k, n_spatial)
    got = reflect_conv_shard_aligned(_cf(x), w, torch.from_numpy(b),
                                     n_spatial, alpha)
    got = got.movedim(1, -1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    plain = reflect_conv_ad(_cf(x), w, torch.from_numpy(b), n_spatial,
                            alpha).movedim(1, -1).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-5)


@pytest.mark.parametrize('n_spatial,shape', CASES)
@pytest.mark.parametrize('alpha', [None, 0.2])
def test_shard_aligned_custom_vjp_grads(n_spatial, shape, alpha):
    """The custom backward's gradients against the JAX package's custom
    VJP and against autograd of the port's own shard-aligned forward."""
    x, k, b, cot = _inputs(n_spatial, shape, 2)
    want = jax.grad(
        lambda x, k, b: jnp.sum(jax_shard_aligned(x, k, b, n_spatial, alpha)
                                * cot), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    want = [np.asarray(g) for g in want]
    cot_t = _cf(cot)

    def grads(fn):
        xt = _cf(x).requires_grad_(True)
        wt = _weight(k, n_spatial).requires_grad_(True)
        bt = torch.from_numpy(b).requires_grad_(True)
        (fn(xt, wt, bt) * cot_t).sum().backward()
        return [xt.grad.movedim(1, -1).numpy(),
                wt.grad.permute(*range(2, 2 + n_spatial), 1, 0).numpy(),
                bt.grad.numpy()]

    custom = grads(lambda x, w, b: reflect_conv_shard_aligned(
        x, w, b, n_spatial, alpha))
    auto = grads(lambda x, w, b: torch.nn.functional.leaky_relu(
        _sa_forward(x, w, b, n_spatial), alpha) if alpha is not None
        else _sa_forward(x, w, b, n_spatial))
    for name, c, a, j in zip(('dx', 'dk', 'db'), custom, auto, want):
        scale = float(np.abs(j).max())
        np.testing.assert_allclose(c, j, rtol=0, atol=1e-5 * scale,
                                   err_msg=f'{name} vs JAX')
        np.testing.assert_allclose(c, a, rtol=0, atol=2e-5 * scale,
                                   err_msg=f'{name} vs autograd')


@pytest.mark.parametrize('n_spatial,shape', CASES)
@pytest.mark.parametrize('blocks', [2, 3])
def test_halo_conv_blocks_equal_the_unsplit_conv(n_spatial, shape, blocks):
    """``reflect_conv_halo`` on each block of s1 rows, with its
    neighbours' boundary rows (its own reflect row at a global edge),
    gives the unsplit conv's rows, and takes gradients
    (tests/test_torch_halo_grad.py holds them)."""
    x, k, b, _ = _inputs(n_spatial, shape, 3)
    x = np.concatenate([x] * blocks, axis=1)[:, :2 * blocks * 2]
    xt, w, bt = _cf(x), _weight(k, n_spatial), torch.from_numpy(b)
    want = reflect_conv_ad(xt, w, bt, n_spatial, 0.2)
    parts = list(xt.chunk(blocks, dim=2))
    outs = [reflect_conv_halo(
        part, w, bt, n_spatial, 0.2,
        None if i == 0 else parts[i - 1][:, :, -1:],
        None if i == blocks - 1 else parts[i + 1][:, :, :1])
        for i, part in enumerate(parts)]
    torch.testing.assert_close(torch.cat(outs, dim=2), want, rtol=1e-6,
                               atol=1e-6)
    reflect_conv_halo(parts[0], w.requires_grad_(True), bt, n_spatial,
                      None).sum().backward()
    assert w.grad is not None and float(w.grad.abs().sum()) > 0
    w.requires_grad_(False)
    with pytest.raises(ValueError, match='>= 2 s1 rows'):
        with torch.no_grad():
            reflect_conv_halo(parts[0][:, :, :1], w, bt, n_spatial, None)


def test_shard_aligned_worthwhile():
    assert [shard_aligned_worthwhile(n) for n in (1, 2, 3, 4, 8)] == [
        False, False, False, True, True]


def test_whole_generator_equivalence_and_cache_key():
    """The flagship generator with ``inference_shard_aligned`` on vs off
    (and off again, bit-equal), the fused-apply cache holding one entry
    per setting, and the shard-aligned output against the JAX package's
    with the same weights."""
    gen, disc = (get_config('spatiotemporal/gen_3x_4x_2f'),
                 get_config('spatiotemporal/disc_test'))
    jmodel = JaxGan(gen, disc)
    jmodel.init_weights((1, 8, 8, 4, 2), (1, 24, 24, 16, 2))
    model = Sup3rGan(gen, disc, device='cpu')
    model.init_weights((1, 8, 8, 4, 2), (1, 24, 24, 16, 2))
    params_from_jax(model.generator,
                    jax.tree.map(np.asarray, jmodel.gen_params))
    x = np.random.default_rng(1).random((1, 8, 8, 4, 2)).astype(np.float32)
    kw = dict(norm_in=False, un_norm_out=False)
    base = model.generate(x, **kw)
    model.inference_shard_aligned = True
    aligned = model.generate(x, **kw)
    fused = model._get_fused_apply()
    assert all(lyr.shard_aligned for lyr in fused.layers
               if isinstance(lyr, FusedReflectConv))
    jmodel.inference_shard_aligned = True
    want = np.asarray(jmodel.generate(x, **kw))
    model.inference_shard_aligned = False
    again = model.generate(x, **kw)
    assert len(model._fused_cache_entries) == 2
    np.testing.assert_allclose(aligned, base, atol=1e-4)
    np.testing.assert_array_equal(again, base)
    np.testing.assert_allclose(aligned, want, atol=1e-4)
