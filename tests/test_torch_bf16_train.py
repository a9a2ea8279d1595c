"""The port's mixed-precision training (``train_dtype='bfloat16'``)
against its own float32 run and the JAX package's bf16 run, on the
fixture of tests/training/test_bf16_train.py: the same H5 file, the same
weights (carried across by ``params_from_jax``) and the same sampled
batches (both ``RANDOM_GENERATOR``s reseeded). The bars are that test's:
loss columns within rtol 0.05 / atol 0.02, the final generator kernel
within atol 0.01 (docs/PERFORMANCE.md "Mixed-precision training"). The
master weights, their gradients and the optimizer's moments stay float32,
and bf16 training runs each network in bf16. The fused blocks'
``reflect_conv_ad`` and its custom backward run in bf16 and hold to the
JAX package's ``reflect_conv_ad`` in bf16 within 2e-2 of each output's
largest magnitude (a few bf16 roundings, 2^-8 each)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sup3r_tpu.utilities.utilities as jax_uu
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.ops.conv_ad import reflect_conv_ad as jax_reflect_conv_ad
from sup3r_tpu.preprocessing import BatchHandler as JaxBatchHandler
from sup3r_tpu.preprocessing import DataHandler as JaxDataHandler
from sup3r_tpu.utilities.test_helpers import make_fake_h5_file
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.weights import params_from_jax, params_to_jax
from sup3r_tpu_torch.ops.conv_ad import reflect_conv_ad
from sup3r_tpu_torch.preprocessing import BatchHandler, DataHandler
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR

torch.set_num_threads(1)

FEATURES = ['windspeed_100m', 'winddirection_100m']
RES = {'spatial': '30km', 'temporal': '60min'}
LOSSES = ('train_loss_gen', 'train_loss_disc')


def _reseed():
    for rng in (RANDOM_GENERATOR, jax_uu.RANDOM_GENERATOR):
        rng.bit_generator.state = np.random.default_rng(
            seed=77).bit_generator.state


def _gen():
    return [
        {'class': 'FlexiblePadding',
         'paddings': [[0, 0], [1, 1], [1, 1], [1, 1], [0, 0]],
         'mode': 'REFLECT'},
        {'class': 'Conv3D', 'filters': 8, 'kernel_size': 3,
         'strides': 1},
        {'class': 'LeakyReLU', 'alpha': 0.2},
        {'class': 'SpatioTemporalExpansion', 'spatial_mult': 2,
         'temporal_mult': 2, 'temporal_method': 'nearest'},
        {'class': 'Conv3D', 'filters': 2, 'kernel_size': 3,
         'strides': 1, 'padding': 'same'},
    ]


def _disc():
    return [{'class': 'Conv3D', 'filters': 4, 'kernel_size': 3,
             'strides': 2, 'padding': 'same'},
            {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]


def _handler(package, path):
    DH, BH = ((DataHandler, BatchHandler) if package == 'port'
              else (JaxDataHandler, JaxBatchHandler))
    return BH([DH(path, features=FEATURES)], batch_size=4, n_batches=3,
              s_enhance=2, t_enhance=2, sample_shape=(8, 8, 4),
              max_workers=1)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{(package, dtype): (history, final generator kernel, model)} of
    test_bf16_train.py's two-epoch run, from the JAX init (seed 5)."""
    path = make_fake_h5_file(
        str(tmp_path_factory.mktemp('bf16') / 'wtk.h5'), (16, 16, 40),
        FEATURES, value_range=(0, 20))
    start = None
    out = {}
    for package in ('jax', 'port'):
        for dtype in (None, 'bfloat16'):
            _reseed()
            bh = _handler(package, path)
            if package == 'jax':
                model = JaxGan(_gen(), _disc(), learning_rate=1e-3)
                model.train_dtype = dtype
                model.init_weights((1, 4, 4, 2, 2), (1, 8, 8, 4, 2), seed=5)
                start = [jax.tree.map(np.asarray, p) for p in
                         (model.gen_params, model.disc_params)]
            else:
                model = Sup3rGan(_gen(), _disc(), learning_rate=1e-3,
                                 device='cpu')
                model.train_dtype = dtype
                model.init_weights((1, 4, 4, 2, 2), (1, 8, 8, 4, 2))
                params_from_jax(model.generator, start[0])
                params_from_jax(model.discriminator, start[1])
            model.train(bh, input_resolution=RES, n_epoch=2, out_dir=None)
            bh.stop()
            if package == 'jax':
                params = jax.tree.map(np.asarray, model.gen_params)
                hist = {c: model.history[c].to_numpy(dtype=float)
                        for c in LOSSES}
            else:
                params = params_to_jax(model.generator)
                hist = {c: np.asarray(model.history[c], float)
                        for c in LOSSES}
            kernel = next(p for p in params if 'kernel' in p)['kernel']
            out[package, dtype] = (hist, kernel, model)
    return out


@pytest.mark.parametrize('against', [('port', None), ('jax', 'bfloat16')],
                         ids=['port_fp32', 'jax_bf16'])
def test_bf16_losses_track(runs, against):
    hist16, _, _ = runs['port', 'bfloat16']
    other, _, _ = runs[against]
    for col in LOSSES:
        assert np.isfinite(hist16[col]).all()
        np.testing.assert_allclose(hist16[col], other[col], rtol=0.05,
                                   atol=0.02, err_msg=col)


@pytest.mark.parametrize('against', [('port', None), ('jax', 'bfloat16')],
                         ids=['port_fp32', 'jax_bf16'])
def test_bf16_final_kernel_close(runs, against):
    _, w16, _ = runs['port', 'bfloat16']
    _, other, _ = runs[against]
    assert w16.dtype == np.float32
    np.testing.assert_allclose(w16, other, rtol=0, atol=0.01)


def test_bf16_takes_another_path(runs):
    """The two port runs genuinely took different compute paths."""
    _, w32, _ = runs['port', None]
    _, w16, _ = runs['port', 'bfloat16']
    assert not np.array_equal(w32, w16)


def test_bf16_master_weights_and_moments_are_float32(runs):
    _, _, model = runs['port', 'bfloat16']
    for p in (*model.gen_params, *model.disc_params):
        assert p.dtype == torch.float32
    for state in (model._gen_opt_state, model._disc_opt_state):
        for key in ('mu', 'nu'):
            assert all(m.dtype == torch.float32 for m in state[key])


def test_bf16_step_runs_the_networks_in_bf16(runs):
    """Inside a bf16 step each conv sees a bf16 input and its float32
    param's gradient comes back float32."""
    _, _, model = runs['port', 'bfloat16']
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].dtype, out.dtype)))
        for net in (model.generator, model.discriminator)
        for m in net.layers if type(m).__name__ == 'Conv3D']
    try:
        lr = torch.rand((2, 4, 4, 2, 2))
        hr = torch.rand((2, 8, 8, 4, 2))
        cast = model._train_cast()
        out = model._train_gen_net().apply(cast(lr), {})
        loss = out.float().square().mean() + model.discriminator.apply(
            cast(hr)).float().mean()
        grads = torch.autograd.grad(loss, model.gen_params)
    finally:
        for h in hooks:
            h.remove()
    assert seen and all(a == b == torch.bfloat16 for a, b in seen)
    assert all(g.dtype == torch.float32 for g in grads)


@pytest.mark.parametrize('n_spatial', [2, 3])
@pytest.mark.parametrize('alpha', [None, 0.2])
def test_reflect_conv_ad_bf16_matches_jax(n_spatial, alpha):
    """The block's value and its (dx, dweight, dbias) in bf16: the
    LeakyReLU mask, the reflect-halo fold and the weight gradient in
    the gradient's dtype."""
    rng = np.random.default_rng(8)
    spatial = (6, 5, 4)[:n_spatial]
    x = rng.standard_normal((2, *spatial, 3)).astype(np.float32)
    k = (rng.standard_normal((3,) * n_spatial + (3, 4))
         / 3 ** n_spatial).astype(np.float32)
    b = (rng.standard_normal(4) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, *spatial, 4)).astype(np.float32)

    def loss(x, k, b):
        y = jax_reflect_conv_ad(x, k, b, n_spatial, alpha)
        return jnp.sum(y.astype(jnp.float32) * dy)

    args = [jnp.asarray(a, jnp.bfloat16) for a in (x, k, b)]
    want_y = jax_reflect_conv_ad(*args, n_spatial, alpha)
    want = jax.grad(loss, argnums=(0, 1, 2))(*args)

    def cf(a):
        return torch.from_numpy(a).movedim(-1, 1)

    leaves = [cf(x).to(torch.bfloat16).requires_grad_(),
              torch.from_numpy(k).permute(n_spatial + 1, n_spatial,
                                          *range(n_spatial))
              .to(torch.bfloat16).requires_grad_(),
              torch.from_numpy(b).to(torch.bfloat16).requires_grad_()]
    y = reflect_conv_ad(*leaves, n_spatial, alpha)
    got = torch.autograd.grad(y, leaves, cf(dy).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in got)
    back = (lambda t: t.float().movedim(1, -1).numpy(),
            lambda t: t.float().permute(*range(2, 2 + n_spatial), 1,
                                        0).numpy(),
            lambda t: t.float().numpy())
    pairs = [('y', back[0](y.detach()), want_y)] + [
        (name, f(g), w) for name, f, g, w in zip(('dx', 'dw', 'db'), back,
                                                 got, want)]
    for name, g, w in pairs:
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-2 * float(np.abs(w).max()),
                                   err_msg=name)
