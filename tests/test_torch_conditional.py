"""The port's conditional-moment family (``Sup3rCondMom``, the six
``QueueMom*`` queues and ``BatchHandlerMom*`` handlers, the simple
enhancing functions) against the JAX package's on the same inputs.

- The enhancing functions: tests/parity/test_reference_enhancing.py's
  cases, numpy in both packages bit-equal (error text included), a
  torch tensor within 2e-7 (float32 weights).
- The queues: tests/batch_handlers/test_conditional_queues.py's
  handlers, their ``post_proc`` on the same seeded samples: the LR / HR
  pair, the mask and the target bit-equal; the second-moment targets
  (the lower model's output inside) within 1e-5 of their largest
  magnitude, the lower models holding the same weights in both.
- One train step (two, Adam ``epsilon=1`` as
  tests/test_torch_train_step.py explains) against the JAX step at rtol
  1e-4: losses, weights and Adam moments, 4D and 5D generators and a
  topography exo channel (tests/training/test_train_conditional.py).
- ``generate`` at rtol 1e-4, ``update_optimizer``, checkpoints saved in
  one package resuming in the other with the same next step, the
  ``end_t_padding`` mask, and ``train`` (history, validation,
  checkpoints, resume)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sup3r_tpu.models import Sup3rCondMom as JaxCondMom
from sup3r_tpu.ops.coarsen import (
    spatial_simple_enhancing as jax_spatial_enhance,
)
from sup3r_tpu.ops.coarsen import (
    temporal_simple_enhancing as jax_temporal_enhance,
)
from sup3r_tpu.preprocessing import batch_handlers as jax_handlers
from sup3r_tpu.utilities.test_helpers import make_fake_dset as jax_fake_dset
from sup3r_tpu_torch.models import Sup3rCondMom
from sup3r_tpu_torch.models.weights import moments_to_jax, params_to_jax
from sup3r_tpu_torch.ops.coarsen import (
    spatial_simple_enhancing,
    temporal_simple_enhancing,
)
from sup3r_tpu_torch.preprocessing import (
    ConditionalBatch,
    batch_handlers,
)
from sup3r_tpu_torch.utilities.test_helpers import make_fake_dset

torch.set_num_threads(1)

RTOL = 1e-4
STEP_OPT = {'name': 'Adam', 'learning_rate': 1e-4, 'epsilon': 1.0}
FEATURES = ['u_100m', 'v_100m']
RES = {'spatial': '12km', 'temporal': '60min'}
HANDLERS = ('BatchHandlerMom1', 'BatchHandlerMom1SF', 'BatchHandlerMom2',
            'BatchHandlerMom2Sep', 'BatchHandlerMom2SF',
            'BatchHandlerMom2SepSF')


# ----------------------------------------------------------------------
# the simple enhancing functions
def _enhance_cases():
    cases = []
    for shape, obs_axis in (((2, 4, 5, 6, 3), True), ((2, 4, 5, 3), True),
                            ((4, 5, 6, 3), False), ((4, 5, 3), False)):
        for s_enhance in (2, 3, 1, None):
            cases.append(('spatial', shape, (s_enhance, obs_axis)))
    for t_enhance in (2, 4, 1, None):
        cases.append(('constant', (2, 3, 3, 5, 2), (t_enhance, 'constant')))
    for t_enhance in (2, 3, 4):
        cases.append(('linear', (2, 3, 3, 6, 2), (t_enhance, 'linear')))
    cases.append(('spatial', (4, 4), (2, False)))
    cases.append(('constant', (3, 4, 5, 2), (2, 'constant')))
    return cases


def _ids(case):
    kind, shape, args = case
    return f'{kind}-{"x".join(map(str, shape))}-{args[0]}-{args[1]}'


@pytest.mark.parametrize('case', _enhance_cases(), ids=_ids)
def test_enhancing_matches_jax(case):
    kind, shape, args = case
    data = np.random.default_rng(len(shape)).normal(size=shape).astype(
        np.float32)
    fns = ((jax_spatial_enhance, spatial_simple_enhancing)
           if kind == 'spatial' else
           (jax_temporal_enhance, temporal_simple_enhancing))
    try:
        want = np.asarray(fns[0](data, *args))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fns[1](data, *args)
        assert str(got.value) == str(e)
        with pytest.raises(ValueError):
            fns[1](torch.as_tensor(data), *args)
        return
    got = fns[1](data, *args)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    on_torch = fns[1](torch.as_tensor(data), *args)
    assert isinstance(on_torch, torch.Tensor)
    np.testing.assert_allclose(on_torch.numpy(), want, rtol=0, atol=2e-7)
    if kind == 'linear':
        np.testing.assert_array_equal(got[:, :, :, ::args[0]], data)


# ----------------------------------------------------------------------
# the queues
def _gen(spatiotemporal, n_out=2, topo=False, filters=8):
    conv = 'Conv3D' if spatiotemporal else 'Conv2D'
    expand = ({'class': 'SpatioTemporalExpansion', 'spatial_mult': 2,
               'temporal_mult': 2, 'temporal_method': 'nearest'}
              if spatiotemporal else
              {'class': 'SpatialExpansion', 'spatial_mult': 2})
    layers = [{'class': conv, 'filters': filters * 4, 'kernel_size': 3,
               'strides': 1, 'padding': 'same'}, expand,
              {'class': 'LeakyReLU', 'alpha': 0.2}]
    if topo:
        layers.append({'class': 'Sup3rConcat', 'name': 'topography'})
    layers.append({'class': conv, 'filters': n_out, 'kernel_size': 3,
                   'strides': 1, 'padding': 'same'})
    return {'hidden_layers': layers}


def _lr_shape(spatiotemporal, n=1, n_feats=2):
    return (n, 4, 4, 2, n_feats) if spatiotemporal else (n, 4, 4, n_feats)


def _pair(gen, lr_shape, optimizer=STEP_OPT, seed=0, meta=None):
    """(port model, JAX model) holding the port's seeded weights."""
    port = Sup3rCondMom(gen, optimizer=optimizer, meta=dict(meta or {}),
                        device='cpu')
    port.init_weights(lr_shape, seed=seed)
    jax_model = JaxCondMom(gen, optimizer=optimizer)
    jax_model.meta.update(meta or {})
    jax_model.init_weights(lr_shape)
    jax_model.gen_params = jax.tree.map(jnp.asarray, params_to_jax(port._gen))
    jax_model._gen_opt_state = jax_model._gen_tx.init(jax_model.gen_params)
    return port, jax_model


def _mom1_pair(spatiotemporal):
    meta = {'lr_features': FEATURES, 'hr_out_features': FEATURES,
            's_enhance': 2, 't_enhance': 2 if spatiotemporal else 1}
    return _pair(_gen(spatiotemporal), _lr_shape(spatiotemporal), seed=3,
                 meta=meta)


def _handlers(name, spatiotemporal, **kwargs):
    """The port's and the JAX package's handler of the same class over
    the same kind of data."""
    t_enhance = 2 if spatiotemporal else 1
    shape = (8, 8, 8) if spatiotemporal else (8, 8, 1)
    kw = dict(batch_size=2, n_batches=1, s_enhance=2, t_enhance=t_enhance,
              sample_shape=shape, queue_cap=1)
    pair = (_mom1_pair(spatiotemporal) if name in
            ('BatchHandlerMom2', 'BatchHandlerMom2SF') else None)
    out = []
    for i, (module, fake) in enumerate(((batch_handlers, make_fake_dset),
                                        (jax_handlers, jax_fake_dset))):
        extra = dict(kwargs)
        if pair is not None:
            extra['lower_models'] = {1: pair[i]}
        out.append(getattr(module, name)(
            [fake((16, 16, 24), FEATURES)], [], **kw, **extra))
    return out


def _samples(handler, seed=0):
    shape = (2, *handler._queue.sample_shape, len(FEATURES))
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize('spatiotemporal', [True, False],
                         ids=['5d', '4d'])
@pytest.mark.parametrize('name', HANDLERS)
def test_queue_batches_match_jax(name, spatiotemporal):
    port, jax_handler = _handlers(name, spatiotemporal, s_padding=1,
                                  t_padding=1, time_enhance_mode='linear')
    samples = _samples(port)
    got = port._queue.post_proc(samples)
    want = jax_handler._queue.post_proc(samples)
    assert isinstance(got, ConditionalBatch)
    for key in ('low_res', 'high_res', 'mask'):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert got.output.dtype == np.asarray(want.output).dtype
    if 'Mom2' in name and 'Sep' not in name:
        # the lower model's output inside: fp32 rounding of two packages
        np.testing.assert_allclose(
            got.output, want.output, rtol=0,
            atol=1e-5 * float(np.abs(want.output).max()))
        assert (got.output >= 0).all()
    else:
        np.testing.assert_array_equal(got.output, want.output)
    mask = got.mask
    assert (mask[:, 0] == 0).all() and (mask[:, :, -1] == 0).all()
    assert (mask[:, 1:-1, 1:-1] == 1).all() if not spatiotemporal else (
        mask[:, 1:-1, 1:-1, 1:-1] == 1).all()


def test_mom2_target_from_the_producer_thread():
    """A ``BatchHandlerMom2``'s batches, made in its producer thread,
    hold ``(hr - mom1(lr))^2`` with mom1's fused generator, staged as a
    ``ConditionalBatch`` of tensors on the model's device."""
    port, _ = _handlers('BatchHandlerMom2', True)
    mom1 = port._queue.lower_models[1]
    try:
        batch = next(iter(port))
    finally:
        port.stop()
    assert isinstance(batch, ConditionalBatch)
    assert all(isinstance(t, torch.Tensor) for t in batch)
    lr, hr = batch.low_res.numpy(), batch.high_res.numpy()
    want = (hr - mom1.generate(lr, norm_in=False, un_norm_out=False)) ** 2
    np.testing.assert_allclose(batch.output.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize('spatiotemporal', [True, False], ids=['5d', '4d'])
def test_end_t_padding_mask(spatiotemporal):
    port, jax_handler = _handlers('BatchHandlerMom1', spatiotemporal,
                                  end_t_padding=True, t_padding=1)
    samples = _samples(port, seed=4)
    got = port._queue.post_proc(samples).mask
    np.testing.assert_array_equal(
        got, jax_handler._queue.post_proc(samples).mask)
    if spatiotemporal:
        # t_padding 1 at the start; at the end t_padding plus the last
        # t_enhance - 1 steps
        assert not got[:, :, :, 0].any() and not got[:, :, :, -2:].any()
        assert got[:, :, :, 1:-2].all()
    else:
        assert got.all()


def test_device_transform_is_refused():
    with pytest.raises(NotImplementedError, match='device_transform'):
        batch_handlers.BatchHandlerMom1(
            [make_fake_dset((16, 16, 24), FEATURES)], batch_size=2,
            n_batches=1, s_enhance=2, sample_shape=(8, 8, 1),
            device_transform=True)


# ----------------------------------------------------------------------
# the train step, generate, the optimizer
MODELS = {
    '5d': (True, False),
    '4d': (False, False),
    '4d_topography': (False, True),
}


def _step_setup(name, handler='BatchHandlerMom1'):
    spatiotemporal, topo = MODELS[name]
    features = FEATURES + ['topography'] if topo else FEATURES
    gen = _gen(spatiotemporal, topo=topo)
    meta = {'lr_features': features, 'hr_out_features': FEATURES,
            's_enhance': 2, 't_enhance': 2 if spatiotemporal else 1}
    port, jax_model = _pair(gen, _lr_shape(spatiotemporal,
                                           n_feats=len(features)),
                            meta=meta)
    shape = (8, 8, 8) if spatiotemporal else (8, 8, 1)
    jax_handler = getattr(jax_handlers, handler)(
        [jax_fake_dset((16, 16, 24), features)], [], batch_size=2,
        n_batches=1, s_enhance=2, t_enhance=2 if spatiotemporal else 1,
        sample_shape=shape, s_padding=1,
        feature_sets={'hr_exo_features': ['topography']} if topo else None)
    samples = np.random.default_rng(7).random(
        (2, *shape, len(features))).astype(np.float32)
    batch = jax_handler._queue.post_proc(samples)
    return port, jax_model, batch


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _compare(port, jax_model):
    state = port._gen_opt_state
    assert state['count'] == int(jax_model._gen_opt_state[0].count)
    moments = {m: moments_to_jax(port._gen, state[m]) for m in ('mu', 'nu')}
    for i, (got, want) in enumerate(zip(params_to_jax(port._gen),
                                        jax_model.gen_params)):
        for key in want:
            _close(got[key], want[key], f'layer {i} {key}')
            for m in ('mu', 'nu'):
                _close(moments[m][str(i)][key],
                       getattr(jax_model._gen_opt_state[0], m)[i][key],
                       f'layer {i} {key} {m}')


@pytest.mark.parametrize('handler', ['BatchHandlerMom1',
                                     'BatchHandlerMom2Sep'])
@pytest.mark.parametrize('name', list(MODELS))
def test_train_step_matches_jax(name, handler):
    """Two steps on one conditional batch (mask with s_padding 1); the
    Mom2Sep target transforms the exo channel, which the loss takes from
    the target."""
    port, jax_model, batch = _step_setup(name, handler)
    for _ in range(2):
        want = jax_model.run_gradient_descent(batch)
        got = port.run_gradient_descent(batch)
        assert sorted(got) == sorted(want) == ['loss_gen']
        np.testing.assert_allclose(got['loss_gen'], want['loss_gen'],
                                   rtol=RTOL)
    _compare(port, jax_model)
    loss, _ = port.calc_loss(
        batch.output, port._train_gen_net().apply(
            torch.as_tensor(batch.low_res),
            port._split_exo(torch.as_tensor(batch.high_res))), batch.mask)
    want, _ = jax_model.calc_loss(
        jnp.asarray(batch.output), jax_model._get_gen_apply()(
            jax_model.gen_params, jnp.asarray(batch.low_res),
            jax_model._split_exo_dict(batch.high_res)),
        jnp.asarray(batch.mask))
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=RTOL)


@pytest.mark.parametrize('name', list(MODELS))
def test_generate_matches_jax(name):
    port, jax_model, batch = _step_setup(name)
    stats = ({f: 0.1 for f in port.lr_features},
             {f: 0.9 for f in port.lr_features})
    for model in (port, jax_model):
        model.set_norm_stats(*stats)
    rng = np.random.default_rng(2)
    spatiotemporal, topo = MODELS[name]
    lr = rng.random((1, 5, 5, 3, 2) if spatiotemporal
                    else (1, 5, 5, 2)).astype(np.float32)
    exo = None
    if topo:
        raster = rng.random((1, 10, 10, 1)).astype(np.float32)
        exo = {'topography': {'steps': [
            {'model': 0, 'combine_type': 'input',
             'data': rng.random((1, 5, 5, 1)).astype(np.float32)},
            {'model': 0, 'combine_type': 'layer', 'data': raster}]}}
    want = jax_model.generate(lr, exogenous_data=exo)
    got = port.generate(lr, exogenous_data=exo)
    assert got.shape == want.shape
    _close(got, want, 'generate')


def test_update_optimizer_matches_jax():
    port, jax_model, batch = _step_setup('4d')
    for model in (port, jax_model):
        model.run_gradient_descent(batch)
    state = port._gen_opt_state
    for model in (port, jax_model):
        model.update_optimizer(learning_rate=5e-4)
    assert port._optimizer_config == jax_model._optimizer_config
    assert port._gen_opt_state is state and state['count'] == 1
    for model in (port, jax_model):
        model.run_gradient_descent(batch)
    _compare(port, jax_model)


# ----------------------------------------------------------------------
# checkpoints, both ways; train()
def test_port_save_resumes_in_jax(tmp_path):
    port, jax_model, batch = _step_setup('4d_topography')
    port.set_norm_stats({f: 0.1 for f in port.lr_features},
                        {f: 0.9 for f in port.lr_features})
    port.run_gradient_descent(batch)
    port.save(str(tmp_path / 'port'))
    loaded = JaxCondMom.load(str(tmp_path / 'port'))
    assert loaded._optimizer_config == port._optimizer_config
    assert loaded.hr_exo_features == ['topography']
    _compare(port, loaded)
    for model in (port, loaded):
        model.run_gradient_descent(batch)
    _compare(port, loaded)


def test_jax_save_resumes_in_the_port(tmp_path):
    port, jax_model, batch = _step_setup('5d')
    jax_model.set_norm_stats({f: 0.2 for f in FEATURES},
                             {f: 1.1 for f in FEATURES})
    jax_model.run_gradient_descent(batch)
    jax_model.save(str(tmp_path / 'jax'))
    loaded = Sup3rCondMom.load(str(tmp_path / 'jax'), device='cpu')
    assert loaded._means == jax_model._means
    _compare(loaded, jax_model)
    for model in (loaded, jax_model):
        model.run_gradient_descent(batch)
    _compare(loaded, jax_model)
    lr = np.random.default_rng(5).random((1, 5, 5, 3, 2)).astype(np.float32)
    _close(loaded.generate(lr), jax_model.generate(lr), 'generate')


@pytest.mark.parametrize('name', ['BatchHandlerMom1SF', 'BatchHandlerMom2'])
def test_train_history_checkpoint_and_resume(tmp_path, name):
    """``train`` over a handler with validation: history, checkpoints,
    a reloaded model that serves and resumes (tests/training/
    test_train_conditional.py)."""
    kwargs = {'s_padding': 1, 'time_enhance_mode': 'linear'}
    if name == 'BatchHandlerMom2':
        kwargs['lower_models'] = {1: _mom1_pair(True)[0]}
    handler = getattr(batch_handlers, name)(
        [make_fake_dset((20, 20, 48), FEATURES)],
        [make_fake_dset((20, 20, 24), FEATURES)], batch_size=2, n_batches=2,
        s_enhance=2, t_enhance=2, sample_shape=(8, 8, 4),
        queue_kwargs=kwargs)
    model = Sup3rCondMom(_gen(True), learning_rate=5e-3, device='cpu')
    out_dir = str(tmp_path / 'mom_{epoch}')
    model.train(handler, input_resolution=RES, n_epoch=2, checkpoint_int=2,
                out_dir=out_dir)
    assert model.history.index == [0, 1]
    for col in ('train_loss_gen', 'val_loss_gen', 'elapsed_time'):
        assert np.isfinite(model.history[col]).all()
    assert model.meta['class'] == 'Sup3rCondMom'
    assert os.path.exists(tmp_path / 'mom_0') and os.path.exists(
        tmp_path / 'mom_1')
    loaded = Sup3rCondMom.load(str(tmp_path / 'mom_1'), device='cpu')
    lr = np.random.default_rng(0).random((1, 5, 5, 3, 2)).astype(np.float32)
    out = loaded.generate(lr)
    assert out.shape == (1, 10, 10, 6, 2) and np.isfinite(out).all()
    np.testing.assert_allclose(out, model.generate(lr), rtol=1e-6)
    loaded.train(handler, input_resolution=RES, n_epoch=1, out_dir=None)
    assert loaded.history.index == [0, 1, 2]
    assert loaded._gen_opt_state['count'] == 6


def test_no_card_without_explicit_cpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Sup3rCondMom(_gen(False))
    assert Sup3rCondMom(_gen(False), device='cpu').device.type == 'cpu'
