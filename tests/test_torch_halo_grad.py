"""Gradients through the fused block on blocks of s1 rows
(``ops/conv_ad.py``: ``reflect_conv_halo`` and its ``ReflectConvHalo``
backward), held without ranks: each block takes its neighbours' boundary
rows as tensors that need gradients, so autograd hands each halo row's
gradient back to the block that owns the row (what the halo exchange's
backward does across ranks). The blocks' gradients, concatenated, are
held to the unsplit ``reflect_conv_ad``'s and to the JAX package's
``reflect_conv_ad`` on the same numpy inputs, with and without the
activation, on blocks of equal and of unequal rows.

Also ``train_shard_aligned`` without a mesh: ``True`` runs
``reflect_conv_shard_aligned`` in the fused blocks, and the step matches
the JAX package's step with its ``train_shard_aligned=True``.

Bars: the gradients within 1e-5 of each gradient's largest magnitude
(as chip_smoke.py's ``kernel_grad_check`` holds the unsharded ones); the
forward within 1e-6; the step at the JAX package's mesh-step bar (rtol
2e-4, atol 1e-6, Adam with epsilon 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.ops.conv_ad import reflect_conv_ad as jax_reflect_conv_ad
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.fuse import FusedReflectConv
from sup3r_tpu_torch.models.weights import params_to_jax
from sup3r_tpu_torch.ops.conv_ad import reflect_conv_ad, reflect_conv_halo

torch.set_num_threads(1)

CASES = [(3, (2, 12, 6, 5, 4)), (2, (3, 12, 7, 4))]
#: s1 blocks of the 12 rows: equal, unequal, and 2-row edge blocks
BLOCKS = [(4, 4, 4), (5, 4, 3), (2, 3, 3, 2, 2)]


def _inputs(n_spatial, shape, seed):
    """(x, kernel, bias, cotangent) channels-last numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3,) * n_spatial + (shape[-1], 6))
         * 0.1).astype(np.float32)
    b = (rng.standard_normal(6) * 0.1).astype(np.float32)
    cot = rng.standard_normal(shape[:-1] + (6,)).astype(np.float32)
    return x, k, b, cot


def _cf(a):
    return torch.from_numpy(a).movedim(-1, 1).contiguous()


def _weight(k, n_spatial):
    return torch.from_numpy(k).permute(
        n_spatial + 1, n_spatial, *range(n_spatial)).contiguous()


def _grads(fn, x, k, b, cot, n_spatial):
    """[dx, dkernel, dbias] channels-last numpy of sum(fn(x, w, b) *
    cot)."""
    xt = _cf(x).requires_grad_(True)
    wt = _weight(k, n_spatial).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = fn(xt, wt, bt)
    (y * _cf(cot)).sum().backward()
    return y.detach(), [xt.grad.movedim(1, -1).numpy(),
                        wt.grad.permute(*range(2, 2 + n_spatial), 1,
                                        0).numpy(),
                        bt.grad.numpy()]


def _blocks(blocks, n_spatial, alpha):
    """``fn(x, w, b)``: the blocks of s1 rows, each with its neighbours'
    boundary rows (slices of ``x``, so their gradients flow back to the
    owning block), concatenated."""
    def fn(x, w, b):
        parts = list(x.split(list(blocks), dim=2))
        outs = [reflect_conv_halo(
            part, w, b, n_spatial, alpha,
            None if i == 0 else parts[i - 1][:, :, -1:],
            None if i == len(parts) - 1 else parts[i + 1][:, :, :1])
            for i, part in enumerate(parts)]
        return torch.cat(outs, dim=2)
    return fn


@pytest.mark.parametrize('n_spatial,shape', CASES)
@pytest.mark.parametrize('blocks', BLOCKS)
@pytest.mark.parametrize('alpha', [0.2, None])
def test_halo_blocks_grads_match_unsplit_and_jax(n_spatial, shape, blocks,
                                                 alpha):
    """Every gradient (input, kernel, bias) of the blocks, concatenated,
    against the unsplit conv's and the JAX package's custom VJP; the
    block-edge rows of dx (where a missed halo gradient would show) are
    held on their own too."""
    x, k, b, cot = _inputs(n_spatial, shape, 3)
    want_y, want = _grads(
        lambda x, w, b: reflect_conv_ad(x, w, b, n_spatial, alpha), x, k, b,
        cot, n_spatial)
    got_y, got = _grads(_blocks(blocks, n_spatial, alpha), x, k, b, cot,
                        n_spatial)
    torch.testing.assert_close(got_y, want_y, rtol=0, atol=1e-6)
    jax_want = jax.grad(
        lambda x, k, b: jnp.sum(jax_reflect_conv_ad(x, k, b, n_spatial,
                                                    alpha) * cot),
        argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    for name, g, w, j in zip(('dx', 'dk', 'db'), got, want, jax_want):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                   err_msg=f'{name} vs unsplit')
        np.testing.assert_allclose(g, np.asarray(j), rtol=0,
                                   atol=1e-5 * scale, err_msg=f'{name} vs JAX')
    edges = np.cumsum(blocks)[:-1]
    rows = sorted({int(r) for e in edges for r in (e - 1, e)})
    assert len(rows) == 2 * (len(blocks) - 1)
    scale = float(np.abs(want[0]).max())
    np.testing.assert_allclose(got[0][:, rows], want[0][:, rows], rtol=0,
                               atol=1e-5 * scale)


def test_halo_rows_get_their_gradients():
    """A block's halo rows carry gradients back (none at a global edge),
    and the reflect row's gradient stays on the edge block."""
    x, k, b, cot = _inputs(3, (1, 6, 4, 4, 2), 5)
    xt, w = _cf(x), _weight(k, 3)
    top = xt[:, :, 2:3].clone().requires_grad_(True)
    block = xt[:, :, 3:].clone().requires_grad_(True)
    y = reflect_conv_halo(block, w, torch.from_numpy(b), 3, None, top, None)
    y.sum().backward()
    assert float(top.grad.abs().sum()) > 0
    # the last block's reflect row (its row -2) takes the bottom halo's
    # gradient: its gradient is not the interior rows' pattern
    assert block.grad.shape == block.shape
    with pytest.raises(ValueError, match='>= 2 s1 rows'):
        reflect_conv_halo(block[:, :, :1], w, torch.from_numpy(b), 3, None)


GEN = [{'class': 'FlexiblePadding',
        'paddings': [[0, 0], [3, 3], [3, 3], [3, 3], [0, 0]],
        'mode': 'REFLECT'},
       {'class': 'Conv3D', 'filters': 8, 'kernel_size': 3, 'strides': 1},
       {'class': 'Cropping3D', 'cropping': 2},
       {'class': 'LeakyReLU', 'alpha': 0.2},
       {'class': 'SpatioTemporalExpansion', 'spatial_mult': 2,
        'temporal_mult': 2, 'temporal_method': 'nearest'},
       {'class': 'FlexiblePadding',
        'paddings': [[0, 0], [3, 3], [3, 3], [3, 3], [0, 0]],
        'mode': 'REFLECT'},
       {'class': 'Conv3D', 'filters': 2, 'kernel_size': 3, 'strides': 1},
       {'class': 'Cropping3D', 'cropping': 2}]
DISC = [{'class': 'Conv3D', 'filters': 4, 'kernel_size': 3, 'strides': 2,
         'padding': 'same'},
        {'class': 'LeakyReLU', 'alpha': 0.2},
        {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
OPT = {'name': 'Adam', 'learning_rate': 1e-3, 'epsilon': 1.0}


def test_train_shard_aligned_true_without_mesh(tmp_path):
    """``train_shard_aligned=True`` with no mesh: the fused blocks take
    the shard-aligned formulation, and the step matches the JAX
    package's step with the same flag (and the port's default step
    within fp32 reassociation)."""
    rng = np.random.default_rng(1)
    lr = rng.random((2, 4, 4, 4, 2)).astype(np.float32)
    hr = rng.random((2, 8, 8, 8, 2)).astype(np.float32)
    jmodel = JaxGan(GEN, DISC, optimizer=OPT)
    jmodel.init_weights((1, 4, 4, 4, 2), (1, 8, 8, 8, 2), seed=2)
    jmodel.save(str(tmp_path / 'gan'))
    jmodel.train_shard_aligned = True
    want = jmodel.run_gradient_descent(lr, hr, train_gen=True,
                                       train_disc=True)
    want_params = [jax.tree.map(np.asarray, jmodel.gen_params),
                   jax.tree.map(np.asarray, jmodel.disc_params)]
    runs = {}
    for flag in (True, None):
        model = Sup3rGan.load(str(tmp_path / 'gan'), device='cpu')
        model.train_shard_aligned = flag
        runs[flag] = model.run_gradient_descent(lr, hr, train_gen=True,
                                                train_disc=True)
        fused = [lyr for lyr in model._train_gen_net().layers
                 if isinstance(lyr, FusedReflectConv)]
        assert len(fused) == 2
        assert all(lyr.shard_aligned is bool(flag) for lyr in fused)
        if flag:
            params = [params_to_jax(model.generator),
                      params_to_jax(model.discriminator)]
    for key, value in want.items():
        np.testing.assert_allclose(runs[True][key], value, rtol=2e-4,
                                   atol=1e-6, err_msg=key)
        np.testing.assert_allclose(runs[None][key], runs[True][key],
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    for net, jnet in zip(params, want_params):
        for layer, jlayer in zip(net, jnet):
            for name in layer:
                np.testing.assert_allclose(layer[name], jlayer[name],
                                           rtol=2e-4, atol=1e-6)
