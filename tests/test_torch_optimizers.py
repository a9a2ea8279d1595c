"""The port's optimizers (``sup3r_tpu_torch/models/optimizers.py``)
against the optax optimizers the JAX package builds from the same config
(``_make_optimizer``): TF/Keras key names, three updates on the same
gradients with the second one gated off (not applied, as the JAX train
step's ``lax.cond`` skips it), params and state at rtol 1e-6; with
``mu_dtype`` / ``accumulator_dtype`` bfloat16 the stored moment is
bfloat16 in both, and an AdamW ``mask`` leaves the masked-out leaves
undecayed."""

import inspect
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sup3r_tpu.models.gan import _make_optimizer
from sup3r_tpu_torch.models.optimizers import ACCEPTED, make_optimizer

torch.set_num_threads(1)

SHAPES = [(3, 3, 2, 4), (4,), (5, 1)]

CONFIGS = [
    {'name': 'Adam', 'learning_rate': 1e-3, 'beta_1': 0.8, 'beta_2': 0.99,
     'epsilon': 1e-7},
    {'name': 'Adam', 'learning_rate': 1e-3, 'nesterov': True},
    {'name': 'AdamW', 'learning_rate': 1e-3, 'weight_decay': 1e-2},
    {'name': 'AdamW', 'learning_rate': 1e-3},
    {'name': 'SGD', 'learning_rate': 1e-2},
    {'name': 'SGD', 'learning_rate': 1e-2, 'momentum': 0.9,
     'nesterov': True},
    {'name': 'RMSprop', 'learning_rate': 1e-3, 'rho': 0.8,
     'epsilon': 1e-6},
    {'name': 'RMSprop', 'learning_rate': 1e-3, 'momentum': 0.5,
     'centered': True, 'initial_scale': 0.1},
    {'name': 'RMSprop', 'learning_rate': 1e-3, 'eps_in_sqrt': False,
     'bias_correction': True},
    {'name': 'Adam', 'learning_rate': 1e-3, 'mu_dtype': 'bfloat16'},
    {'name': 'Adam', 'learning_rate': 1e-3, 'nesterov': True,
     'mu_dtype': 'bfloat16'},
    {'name': 'AdamW', 'learning_rate': 1e-3, 'weight_decay': 1e-2,
     'mask': [True, False, True]},
    {'name': 'SGD', 'learning_rate': 1e-2, 'momentum': 0.9,
     'accumulator_dtype': 'bfloat16'},
]


def _flat_state(state):
    """The array leaves of an optax state, in order."""
    return [np.asarray(v).astype(np.float32 if v.dtype == jnp.bfloat16
                                 else v.dtype)
            for v in jax.tree.leaves(state)]


def _port_leaves(opt, state):
    out = []
    for stage in opt.stages(state):
        for key, value in stage.items():
            if key == 'count':
                out.append(np.asarray(value))
            else:
                out.extend((v.float() if v.dtype == torch.bfloat16
                            else v).numpy() for v in value)
    return out


@pytest.mark.parametrize('config', CONFIGS,
                         ids=lambda c: '-'.join(map(str, c.values())))
def test_optimizer_matches_optax(config):
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) * 10 ** -k
              for k, s in enumerate(SHAPES)] for _ in range(3)]
    tx, jcfg = _make_optimizer(dict(config))
    opt, tcfg = make_optimizer(dict(config))
    assert tcfg == jcfg

    jp = [jnp.asarray(p) for p in params]
    js = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = opt.init(tp)
    for step, g in enumerate(grads):
        if step == 1:
            continue  # gated off: no update, the state stays
        updates, js = tx.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tp, [torch.from_numpy(x) for x in g], ts)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    want_leaves = _flat_state(js)
    got_leaves = _port_leaves(opt, ts)
    assert len(got_leaves) == len(want_leaves)
    for got, want in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize('name', ['adam', 'adamw', 'sgd', 'rmsprop'])
def test_accepted_keys_are_optax_signatures(name):
    builder = getattr(optax, name)
    accepted = set(inspect.signature(builder).parameters) - {
        'learning_rate'}
    assert accepted == set(ACCEPTED[name])


def test_dropped_keys_warn_and_defaults_raise(caplog):
    cfg = {'name': 'Adam', 'learning_rate': 2e-4, 'amsgrad': True}
    with caplog.at_level(logging.WARNING):
        _, got = make_optimizer(cfg)
    assert 'amsgrad' in caplog.text
    assert got == _make_optimizer(cfg)[1] == {'name': 'Adam',
                                             'learning_rate': 2e-4}
    with pytest.raises(KeyError, match='Unknown optimizer'):
        make_optimizer({'name': 'Adagrad'})
    # mu_dtype is taken, as optax takes it, and kept in the config
    cfg = {'name': 'Adam', 'mu_dtype': 'bfloat16'}
    opt, got = make_optimizer(dict(cfg))
    assert got == _make_optimizer(dict(cfg))[1]
    params = [torch.zeros(3)]
    assert opt.init(params)['mu'][0].dtype == torch.bfloat16
