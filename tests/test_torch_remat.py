"""The port's rematerialized train step (``train_remat=True``: the
generator's forward under ``torch.utils.checkpoint``, recomputed in the
backward): against the port's own step without it within 1e-6 of each
tensor's largest magnitude, and against the JAX package's remat step
(``jax.checkpoint``) at the fp32 parity bar of
tests/test_torch_train_step.py (rtol 1e-4, Adam epsilon 1, as that file
explains). Train or dropout kwargs to a rematerialized generator apply
raise, as in the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.weights import params_to_jax
from test_torch_train_step import (
    MODELS,
    RTOL,
    STEP_OPT,
    _compare_networks,
)

torch.set_num_threads(1)

REMAT_RTOL = 1e-6
NAMES = ['spatial', 'spatiotemporal']


def _port(name, remat):
    gen, disc, lr_shape, hr_shape = MODELS[name]
    model = Sup3rGan(gen, disc, optimizer=STEP_OPT, device='cpu')
    model.init_weights((1,) + lr_shape[1:], (1,) + hr_shape[1:], seed=0)
    model.train_remat = remat
    return model


def _batch(name):
    _, _, lr_shape, hr_shape = MODELS[name]
    rng = np.random.default_rng(0)
    return (rng.random(lr_shape).astype(np.float32),
            rng.random(hr_shape).astype(np.float32))


@pytest.mark.parametrize('name', NAMES)
def test_remat_step_matches_plain_step(name):
    lr, hr = _batch(name)
    plain, remat = _port(name, False), _port(name, True)
    for _ in range(2):
        want = plain.run_gradient_descent(lr, hr, 1e-3, True, True)
        got = remat.run_gradient_descent(lr, hr, 1e-3, True, True)
        for key in want:
            np.testing.assert_allclose(got[key], want[key],
                                       rtol=REMAT_RTOL, err_msg=key)
    for tag in ('gen', 'disc'):
        want_net, got_net = (getattr(m, f'_{tag}') for m in (plain, remat))
        want_st, got_st = (getattr(m, f'_{tag}_opt_state')
                           for m in (plain, remat))
        pairs = [*zip(want_net.parameters(), got_net.parameters()),
                 *zip(want_st['mu'], got_st['mu']),
                 *zip(want_st['nu'], got_st['nu'])]
        for want, got in pairs:
            want, got = want.detach(), got.detach()
            tol = REMAT_RTOL * float(want.abs().max())
            assert float((got - want).abs().max()) <= tol, tag


@pytest.mark.parametrize('name', NAMES)
def test_remat_step_matches_jax_remat(name):
    lr, hr = _batch(name)
    port = _port(name, True)
    gen, disc, _, _ = MODELS[name]
    jax_model = JaxGan(gen, disc, optimizer=STEP_OPT)
    jax_model.train_remat = True
    jax_model.init_weights(*[(1,) + s[1:] for s in MODELS[name][2:]])
    jax_model.gen_params = jax.tree.map(jnp.asarray,
                                        params_to_jax(port._gen))
    jax_model.disc_params = jax.tree.map(jnp.asarray,
                                         params_to_jax(port._disc))
    jax_model._gen_opt_state = jax_model._gen_tx.init(jax_model.gen_params)
    jax_model._disc_opt_state = jax_model._disc_tx.init(
        jax_model.disc_params)
    for _ in range(2):
        want = jax_model.run_gradient_descent(lr, hr, 1e-3, True, True)
        got = port.run_gradient_descent(lr, hr, 1e-3, True, True)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=key)
    _compare_networks(jax_model, port)


def test_remat_gradients_reach_every_param():
    """Through the checkpoint, every generator param gets its gradient,
    as without it."""
    lr, hr = _batch('spatiotemporal')
    grads = {}
    for remat in (False, True):
        model = _port('spatiotemporal', remat)
        gen_apply = model._maybe_remat(model._train_gen_net().apply)
        out = gen_apply(torch.as_tensor(lr), {})
        grads[remat] = torch.autograd.grad(out.square().mean(),
                                           model.gen_params)
    for a, b in zip(grads[False], grads[True]):
        assert float(b.abs().sum()) > 0
        torch.testing.assert_close(b, a, rtol=0,
                                   atol=REMAT_RTOL * float(a.abs().max()))


def test_remat_refuses_train_kwargs():
    model = _port('spatial', True)
    gen_apply = model._maybe_remat(model._train_gen_net().apply)
    x = torch.rand((1, 6, 6, 2))
    with pytest.raises(NotImplementedError, match='dropout_key'):
        gen_apply(x, {}, dropout_key=1)
    with pytest.raises(NotImplementedError, match='train'):
        gen_apply(x, {}, train=True)
    # without gradients there is nothing to rematerialize
    with torch.no_grad():
        assert gen_apply(x, {}).shape == (1, 12, 12, 2)
