"""Optimizers of the train step, with optax's update rules (the port of
``_make_optimizer`` in ``sup3r_tpu/models/gan.py``).

``make_optimizer`` takes the same config dicts (``{'name': 'Adam',
'learning_rate': 1e-4, ...}``, TF/Keras key spellings mapped to optax's)
and returns the optimizer and the config that ``model_params`` records.
The updates are plain functions on tensors that follow optax 0.2.6, not
``torch.optim``, whose defaults differ:

- ``adam``: optax ``scale_by_adam`` then ``-learning_rate``: moments
  ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias
  corrections by ``1 - b**count``, ``mu_hat / (sqrt(nu_hat + eps_root) +
  eps)``;
- ``adamw``: adam's update plus ``weight_decay * param`` (1e-4 by
  default, on every leaf) before the learning rate;
- ``sgd``: ``trace`` (``t = g + momentum t``, nesterov ``g + momentum
  t``) when ``momentum`` is set, then ``-learning_rate``;
- ``rmsprop``: ``nu = (1 - decay) g^2 + decay nu`` from
  ``initial_scale``, then ``g / sqrt(nu + eps)`` (``eps_in_sqrt=True``,
  optax's default; ``g / (sqrt(nu) + eps)`` otherwise), ``centered``
  subtracting the squared mean, optional bias correction, then
  ``-learning_rate``, then the momentum ``trace``.

The state is a dict of tensors (``count``, ``mu``, ``nu``, ``trace``:
lists aligned with the parameter list). ``update`` changes the
parameters and the state in place; the train step calls it only for an
update it applies, so Adam's ``count`` advances only then, as optax's
does under the JAX step's ``lax.cond``.
"""

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: optax builder arguments per name (optax 0.2.6 signatures, the
#: learning rate aside)
ACCEPTED = {
    'adam': ('b1', 'b2', 'eps', 'eps_root', 'mu_dtype', 'nesterov'),
    'adamw': ('b1', 'b2', 'eps', 'eps_root', 'mu_dtype', 'weight_decay',
              'mask', 'nesterov'),
    'sgd': ('momentum', 'nesterov', 'accumulator_dtype'),
    'rmsprop': ('decay', 'eps', 'initial_scale', 'eps_in_sqrt', 'centered',
                'momentum', 'nesterov', 'bias_correction'),
}
#: TF/Keras spellings in reference configs -> optax names
TF_MAP = {'beta_1': 'b1', 'beta_2': 'b2', 'epsilon': 'eps', 'rho': 'decay'}
#: arguments the port takes only at optax's default
_DEFAULT_ONLY = {'mu_dtype': None, 'mask': None, 'accumulator_dtype': None}


class Optimizer:
    """One optax optimizer's ``init`` / ``update`` on a parameter list."""

    DEFAULTS = {
        'adam': dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                     nesterov=False),
        'adamw': dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                      weight_decay=1e-4, nesterov=False),
        'sgd': dict(momentum=None, nesterov=False),
        'rmsprop': dict(decay=0.9, eps=1e-8, initial_scale=0.0,
                        eps_in_sqrt=True, centered=False, momentum=None,
                        nesterov=False, bias_correction=False),
    }

    def __init__(self, name, learning_rate, **kwargs):
        for key, default in _DEFAULT_ONLY.items():
            if kwargs.pop(key, default) is not default:
                raise NotImplementedError(
                    f'optimizer option {key!r} is taken at its optax '
                    f'default ({default}) only')
        self.name = name
        self.learning_rate = float(learning_rate)
        self.hp = {**self.DEFAULTS[name], **kwargs}

    # ------------------------------------------------------------------
    def init(self, params):
        """Zero state for ``params`` (a list of tensors)."""
        hp = self.hp

        def zeros():
            return [torch.zeros_like(p) for p in params]

        state = {}
        if self.name in ('adam', 'adamw'):
            state = {'count': 0, 'mu': zeros(), 'nu': zeros()}
        elif self.name == 'rmsprop':
            state['nu'] = [torch.full_like(p, hp['initial_scale'])
                           for p in params]
            if hp['centered']:
                state['mu'] = zeros()
            if hp['bias_correction']:
                state['count'] = 0
        if hp.get('momentum') is not None:
            state['trace'] = zeros()
        return state

    def stages(self, state):
        """The state split as optax's chain holds it: one dict per
        transform, in chain order (``opt_state.msgpack``'s layout)."""
        hp = self.hp
        trace = ({'trace': state['trace']} if hp.get('momentum')
                 is not None else {})
        if self.name == 'adam':
            return [dict(state), {}]
        if self.name == 'adamw':
            return [dict(state), {}, {}]
        if self.name == 'sgd':
            return [trace, {}]
        rms = {k: state[k] for k in ('count', 'mu', 'nu') if k in state}
        return [rms, {}, trace]

    def from_stages(self, stages):
        """Inverse of ``stages``."""
        state = {}
        for stage in stages:
            state.update(stage)
        return state

    @torch.no_grad()
    def update(self, params, grads, state):
        """Apply one update to ``params`` in place; ``state`` moves with
        it."""
        hp = self.hp
        params, grads = list(params), [g.detach() for g in grads]
        if self.name in ('adam', 'adamw'):
            u = self._adam(grads, state, params)
        elif self.name == 'sgd':
            u = self._trace(grads, state)
        else:
            u = self._rms(grads, state)
        torch._foreach_mul_(u, -self.learning_rate)
        if self.name == 'rmsprop' and hp['momentum'] is not None:
            u = self._trace(u, state)
        torch._foreach_add_(params, u)

    def _trace(self, updates, state):
        """optax ``trace``: ``t = g + momentum t``; the update is ``t``,
        or ``g + momentum t`` with nesterov."""
        hp = self.hp
        if hp['momentum'] is None:
            return updates
        trace = state['trace']
        torch._foreach_mul_(trace, hp['momentum'])
        torch._foreach_add_(trace, updates)
        if hp['nesterov']:
            return torch._foreach_add(
                updates, torch._foreach_mul(trace, hp['momentum']))
        return [t.clone() for t in trace]

    @staticmethod
    def _ema_(moments, values, decay):
        """``m = (1 - decay) * v + decay * m`` in place (optax's
        ``update_moment``, in its order of operations)."""
        torch._foreach_mul_(moments, decay)
        torch._foreach_add_(moments, torch._foreach_mul(values, 1 - decay))

    def _adam(self, grads, state, params):
        hp = self.hp
        b1, b2 = hp['b1'], hp['b2']
        self._ema_(state['mu'], grads, b1)
        self._ema_(state['nu'], torch._foreach_mul(grads, grads), b2)
        count = state['count'] = _safe_increment(state['count'])
        if hp['nesterov']:
            c1 = _bias(b1, _safe_increment(count))
            mu_hat = torch._foreach_add(
                torch._foreach_mul(torch._foreach_div(state['mu'], c1), b1),
                torch._foreach_mul(
                    torch._foreach_div(grads, _bias(b1, count)), 1 - b1))
        else:
            mu_hat = torch._foreach_div(state['mu'], _bias(b1, count))
        nu_hat = torch._foreach_div(state['nu'], _bias(b2, count))
        denom = torch._foreach_sqrt(torch._foreach_add(nu_hat,
                                                       hp['eps_root']))
        torch._foreach_add_(denom, hp['eps'])
        u = torch._foreach_div(mu_hat, denom)
        if self.name == 'adamw':
            torch._foreach_add_(u, torch._foreach_mul(params,
                                                      hp['weight_decay']))
        return u

    def _rms(self, grads, state):
        """optax ``scale_by_rms`` (``scale_by_stddev`` when centered)."""
        hp = self.hp
        decay = hp['decay']
        self._ema_(state['nu'], torch._foreach_mul(grads, grads), decay)
        nu = state['nu']
        if hp['centered']:
            self._ema_(state['mu'], grads, decay)
            mu = state['mu']
        if hp['bias_correction']:
            count = state['count'] = _safe_increment(state['count'])
            nu = torch._foreach_div(nu, _bias(decay, count))
            if hp['centered']:
                mu = torch._foreach_div(mu, _bias(decay, count))
        if hp['centered']:
            nu = torch._foreach_sub(nu, torch._foreach_mul(mu, mu))
        if hp['eps_in_sqrt']:
            scale = torch._foreach_rsqrt(torch._foreach_add(nu, hp['eps']))
        else:
            scale = torch._foreach_reciprocal(torch._foreach_add(
                torch._foreach_sqrt(nu), hp['eps']))
        return torch._foreach_mul(scale, grads)


def _bias(decay, count):
    """optax's bias correction ``1 - decay**count``, in float32 as it
    computes it."""
    one, d = np.float32(1), np.float32(decay)
    return float(one - np.power(d, np.float32(count)))


def _safe_increment(count):
    """optax ``safe_increment`` of an int32 count: stops at the int32
    maximum."""
    return min(count + 1, 2 ** 31 - 1)


def make_optimizer(config):
    """(Optimizer, config dict) from ``{'name', 'learning_rate', ...}``,
    as the JAX package's ``_make_optimizer`` reads it: TF/Keras key
    spellings map to optax's, every key the optax builder accepts is
    kept, and the others are dropped with a warning."""
    config = dict(config or {})
    name = config.pop('name', 'Adam').lower()
    lr = float(config.pop('learning_rate', 1e-4))
    if name not in ACCEPTED:
        raise KeyError(f'Unknown optimizer "{name}"')
    config = {TF_MAP.get(k, k): v for k, v in config.items()}
    accepted = set(ACCEPTED[name]) | {'learning_rate'}
    kwargs = {k: v for k, v in config.items() if k in accepted}
    dropped = {k: v for k, v in config.items()
               if k not in accepted and k != 'name'}
    if dropped:
        logger.warning(
            'Optimizer "%s" ignores config keys %s (no optax '
            'equivalent)', name, sorted(dropped))
    return (Optimizer(name, lr, **kwargs),
            {'name': name.capitalize(), 'learning_rate': lr, **kwargs})
