"""The port's GAN train step (``sup3r_tpu_torch/models/gan.py``) against
the JAX package's on the CPU: losses, both networks' weights and the Adam
state after 2 steps, for the three gating cases, on a small spatial GAN,
a small spatiotemporal GAN and the full-width flagship on a tiny batch.

Tolerance rtol 1e-4 of each tensor's largest magnitude (the repo's fp32
parity bar). The step tests run Adam with ``epsilon=1``: Adam's update
``m / (sqrt(v) + eps)`` is ``sign(g)`` for any gradient entry far above
eps, so with the default 1e-8 an entry whose gradient is within fp32
rounding of zero (in either package) moves its weight by a full +-lr
either way; with eps = 1 the update is smooth in the gradient and the
weights after a step carry the gradients' agreement (the optimizer's
default-eps arithmetic is held to optax in tests/test_torch_optimizers.py).
The discriminator's last bias is left out: the relativistic loss is
invariant to a common shift of the discriminator's outputs, so its
gradient is 0 and both packages step it by rounding noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sup3r_tpu.configs import get_config
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu_torch.configs import generator_spatial, generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.weights import (
    moments_to_jax,
    params_from_jax,
    params_to_jax,
)

torch.set_num_threads(1)

RTOL = 1e-4
STEP_OPT = {'name': 'Adam', 'learning_rate': 1e-4, 'epsilon': 1.0}
GATES = [(True, True), (True, False), (False, True)]

#: (generator config, discriminator config, lr shape, hr shape); the
#: flagship's weights and inputs come from seed 0
MODELS = {
    'spatial': (generator_spatial(2, (2,), filters=8, n_resblocks=1),
                get_config('spatial/disc_test'), (2, 6, 6, 2),
                (2, 12, 12, 2)),
    'spatiotemporal': (generator_st(2, (3,), (2, 2), filters=8,
                                    n_resblocks=1),
                       get_config('spatiotemporal/disc_test'),
                       (2, 4, 4, 3, 2), (2, 12, 12, 12, 2)),
    'flagship': (get_config('spatiotemporal/gen_3x_4x_2f'),
                 get_config('spatiotemporal/disc_test'), (1, 4, 4, 2, 2),
                 (1, 12, 12, 8, 2)),
}

_PAIRS = {}


def _numpy_params(params):
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _pair(name):
    """(JAX model, port model, initial gen / disc params) with the port's
    seeded weights in both; the JAX model is built once per config so
    its train step compiles once (gating is a traced argument)."""
    if name not in _PAIRS:
        gen, disc, lr_shape, hr_shape = MODELS[name]
        one = ((1,) + lr_shape[1:], (1,) + hr_shape[1:])
        port = Sup3rGan(gen, disc, optimizer=STEP_OPT, device='cpu')
        port.init_weights(*one, seed=0)
        jax_model = JaxGan(gen, disc, optimizer=STEP_OPT)
        jax_model.init_weights(*one)
        _PAIRS[name] = (jax_model, port, params_to_jax(port._gen),
                        params_to_jax(port._disc))
    jax_model, port, gp, dp = _PAIRS[name]
    params_from_jax(port._gen, gp)
    params_from_jax(port._disc, dp)
    port._gen_opt_state = port._gen_tx.init(port.gen_params)
    port._disc_opt_state = port._disc_tx.init(port.disc_params)
    jax_model.gen_params = jax.tree.map(jnp.asarray, gp)
    jax_model.disc_params = jax.tree.map(jnp.asarray, dp)
    jax_model._gen_opt_state = jax_model._gen_tx.init(jax_model.gen_params)
    jax_model._disc_opt_state = jax_model._disc_tx.init(
        jax_model.disc_params)
    return jax_model, port


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _compare_networks(jax_model, port):
    last = len(port._disc.layers) - 1
    for tag, net, jparams, tstate, jstate in (
            ('gen', port._gen, jax_model.gen_params, port._gen_opt_state,
             jax_model._gen_opt_state),
            ('disc', port._disc, jax_model.disc_params,
             port._disc_opt_state, jax_model._disc_opt_state)):
        assert tstate['count'] == int(jstate[0].count)
        moments = {m: moments_to_jax(net, tstate[m]) for m in ('mu', 'nu')}
        for i, (got, want) in enumerate(zip(params_to_jax(net),
                                            _numpy_params(jparams))):
            for key in want:
                if tag == 'disc' and i == last and key == 'bias':
                    assert abs(float(got[key][0])) < 1e-8
                    assert abs(float(want[key][0])) < 1e-8
                    continue
                _close(got[key], want[key], f'{tag} layer {i} {key}')
                for m in ('mu', 'nu'):
                    _close(moments[m][str(i)][key],
                           getattr(jstate[0], m)[i][key],
                           f'{tag} layer {i} {key} {m}')


@pytest.mark.parametrize('gate', GATES, ids=['both', 'gen', 'disc'])
@pytest.mark.parametrize('name', list(MODELS))
def test_train_step_matches_jax(name, gate):
    jax_model, port = _pair(name)
    _, _, lr_shape, hr_shape = MODELS[name]
    rng = np.random.default_rng(0)
    lr = rng.random(lr_shape).astype(np.float32)
    hr = rng.random(hr_shape).astype(np.float32)
    for _ in range(2):
        want = jax_model.run_gradient_descent(lr, hr, 1e-3, *gate)
        got = port.run_gradient_descent(lr, hr, 1e-3, *gate)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=key)
    _compare_networks(jax_model, port)


def test_fused_blocks_train_the_generators_own_params():
    """The fused training network reads the conv layers' params, so its
    gradients land on the generator's own ``nn.Parameter``s."""
    _, port = _pair('spatiotemporal')
    net = port._train_gen_net()
    assert net is not port._gen
    fused_params = {id(p) for p in net.parameters()}
    assert fused_params == {id(p) for p in port.gen_params}
    lr = torch.rand((1, 4, 4, 3, 2))
    out = net.apply(lr, {})
    grads = torch.autograd.grad(out.square().mean(), port.gen_params)
    assert all(g is not None and bool(g.abs().sum() > 0) for g in grads)
