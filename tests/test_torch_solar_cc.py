"""The port's ``SolarCC`` (``sup3r_tpu_torch/models/solar_cc.py``)
against the JAX package's on the CPU, on the same weights and inputs.

The train step draws its daylight windows from a ``torch.Generator``
where the JAX step draws from ``jax.random``, so the two cannot share
draws; the step is held to the JAX package where the draw does not
enter:

- the generator step at ``weight_gen_advers=0`` (the content loss only):
  losses and the generator's weights and Adam moments after 2 steps,
  Adam with epsilon 1 as in tests/test_torch_train_step.py;
- the discriminator's loss over given window starts, against the JAX
  discriminator on the same slices;
- the eager ``calc_loss`` and the validation step (fixed windows).

And: ``generate`` with its ``temporal_pad``, a reflect pad as wide as the
axis (8 hours on 8, 48 on 48) on the device tensor equal to numpy's;
the window starts uniform over [0, T - DAYLIGHT_HOURS]; save / load in
either package with the ``t_enhance`` override; a bf16 and a remat step.
Tolerance rtol 1e-4 of each value's largest magnitude (the repository's
fp32 parity bar) unless a test says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sup3r_tpu.configs import generator_cc_temporal
from sup3r_tpu.models import SolarCC as JaxSolarCC
from sup3r_tpu.models.gan import relativistic_disc_loss as jax_relativistic
from sup3r_tpu_torch.models import SolarCC
from sup3r_tpu_torch.models.gan import relativistic_disc_loss
from sup3r_tpu_torch.models.solar_cc import reflect_pad_time
from sup3r_tpu_torch.models.weights import (
    moments_to_jax,
    params_from_jax,
    params_to_jax,
)

torch.set_num_threads(1)

RTOL = 1e-4
STEP_OPT = {'name': 'Adam', 'learning_rate': 1e-4, 'epsilon': 1.0}
FEATURES = ['clearsky_ratio', 'u_100m', 'v_100m']
DISC = [{'class': 'Conv3D', 'filters': 4, 'kernel_size': 3, 'strides': 2,
         'padding': 'same'},
        {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
GEN = generator_cc_temporal(1, 8, 4, filters=8, n_resblocks=1,
                            chan_per_step=8)
#: a batch of 2, two days: LR (4, 4, 6, 3), HR (4, 4, 48, 1)
LR_SHAPE = (2, 4, 4, 6, 3)
HR_SHAPE = (2, 4, 4, 48, 1)
META = {'lr_features': FEATURES, 'hr_out_features': ['clearsky_ratio'],
        's_enhance': 1, 't_enhance': 8,
        'input_resolution': {'spatial': '4km', 'temporal': '1440min'}}
MEANS = {'clearsky_ratio': 0.5, 'u_100m': 0.1, 'v_100m': -0.2}
STDS = {'clearsky_ratio': 0.2, 'u_100m': 1.5, 'v_100m': 2.0}


def _close(got, want, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = RTOL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(LR_SHAPE).astype(np.float32),
            rng.random(HR_SHAPE).astype(np.float32))


def _pair(loss='MeanSquaredError'):
    """(JAX model, port model) with the port's seeded weights in both."""
    port = SolarCC(GEN, DISC, optimizer=STEP_OPT, loss=loss, meta=dict(META),
                   means=MEANS, stdevs=STDS, device='cpu')
    port.init_weights((1, *LR_SHAPE[1:]), (1, *HR_SHAPE[1:]), seed=0)
    jmodel = JaxSolarCC(GEN, DISC, optimizer=STEP_OPT, loss=loss,
                        meta=dict(META), means=MEANS, stdevs=STDS)
    jmodel.init_weights((1, *LR_SHAPE[1:]), (1, *HR_SHAPE[1:]))
    jmodel.gen_params = jax.tree.map(jnp.asarray, params_to_jax(port._gen))
    jmodel.disc_params = jax.tree.map(jnp.asarray,
                                      params_to_jax(port._disc))
    jmodel._gen_opt_state = jmodel._gen_tx.init(jmodel.gen_params)
    jmodel._disc_opt_state = jmodel._disc_tx.init(jmodel.disc_params)
    return jmodel, port


def test_discriminator_is_built_on_daylight_windows():
    _, port = _pair()
    assert port._disc_in_shape == (1, 4, 4, SolarCC.DAYLIGHT_HOURS, 1)


@pytest.mark.parametrize('t_lr, t_hr', [(1, 8), (6, 48)])
def test_temporal_pad_wider_than_the_axis(t_lr, t_hr):
    """One day of 8 generated hours pads 8 a side, a 6-day chunk's 48
    hours 48 a side: as wide as the axis, where ``F.pad`` refuses and
    numpy reflects again. The device gather equals numpy's pad, and the
    JAX model's."""
    _, port = _pair()
    port.meta['t_enhance'] = 24
    jmodel = JaxSolarCC(GEN, DISC, t_enhance=24)
    hi_res = np.random.default_rng(3).random(
        (1, 3, 2, t_hr, 2)).astype(np.float32)
    low_res = np.zeros((1, 3, 2, t_lr, 3), np.float32)
    want = np.pad(hi_res, ((0, 0),) * 3 + ((t_hr, t_hr), (0, 0)),
                  mode='reflect')
    got = port.temporal_pad(low_res, torch.from_numpy(hi_res))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port.temporal_pad(low_res, hi_res), want)
    np.testing.assert_array_equal(jmodel.temporal_pad(low_res, hi_res),
                                  want)
    assert got.shape[3] == 24 * t_lr


@pytest.mark.parametrize('n, pad', [(1, 3), (2, 5), (5, 12), (7, 6)])
def test_reflect_pad_time_matches_numpy(n, pad):
    x = np.arange(2 * n, dtype=np.float32).reshape(1, n, 2)
    want = np.pad(x, ((0, 0), (pad, pad), (0, 0)), mode='reflect')
    np.testing.assert_array_equal(
        reflect_pad_time(torch.from_numpy(x), pad).numpy(), want)


@pytest.mark.parametrize('t_enhance', [None, 24])
def test_generate_matches_jax(t_enhance):
    """With the serving override the 8x output is reflected to 24x."""
    jmodel, port = _pair()
    for m in (jmodel, port):
        if t_enhance is not None:
            m.meta['t_enhance'] = t_enhance
    lr = _batch()[0]
    want = np.asarray(jmodel.generate(lr))
    got = port.generate(lr)
    assert got.shape == (2, 4, 4, 6 * (t_enhance or 8), 1)
    _close(got, want)
    dev = port.generate(lr, fetch=False)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), got)


@pytest.mark.parametrize('loss', ['MeanSquaredError', 'MeanAbsoluteError'])
def test_generator_step_matches_jax(loss):
    """``weight_gen_advers=0``: the content loss alone, which no window
    draw enters; 2 steps of the generator only."""
    jmodel, port = _pair(loss)
    lr, hr = _batch()
    for _ in range(2):
        want = jmodel.run_gradient_descent(lr, hr, 0.0, True, False)
        got = port.run_gradient_descent(lr, hr, 0.0, True, False)
        for key in ('loss_gen', 'loss_gen_content'):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=key)
        assert np.isfinite(got['loss_disc'])
    assert port._gen_opt_state['count'] == int(jmodel._gen_opt_state[0]
                                               .count)
    mu = moments_to_jax(port._gen, port._gen_opt_state['mu'])
    for i, (p, jp) in enumerate(zip(params_to_jax(port._gen),
                                    jmodel.gen_params)):
        for key in jp:
            _close(p[key], jp[key], f'layer {i} {key}')
            _close(mu[str(i)][key], jmodel._gen_opt_state[0].mu[i][key],
                   f'layer {i} {key} mu')


@pytest.mark.parametrize('starts', [[0, 40], [13, 7], [40, 40]])
def test_disc_loss_over_given_windows_matches_jax(starts):
    """The discriminator's loss as the train step forms it, on the true
    daylight windows and the generated windows at ``starts``, against the
    JAX discriminator on the same slices."""
    jmodel, port = _pair()
    _, hr = _batch()
    out = np.random.default_rng(5).random(HR_SHAPE).astype(np.float32)
    sh, dh = SolarCC.STARTING_HOUR, SolarCC.DAYLIGHT_HOURS
    disc, dp = jmodel._disc, jmodel.disc_params
    d_true = jnp.concatenate([disc.apply(dp, hr[:, :, :, 24 * i + sh:
                                                24 * i + sh + dh])
                              for i in range(2)], axis=0)
    d_gen = jnp.concatenate([disc.apply(dp, out[:, :, :, t0:t0 + dh])
                             for t0 in starts], axis=0)
    want = float(jax_relativistic(d_true, d_gen))
    with torch.no_grad():
        got = float(relativistic_disc_loss(
            port._disc.apply(port.true_windows(torch.from_numpy(hr))),
            port._disc.apply(port.gen_windows(torch.from_numpy(out),
                                              starts))))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_window_starts_are_uniform():
    """Each start is uniform over [0, T - DAYLIGHT_HOURS]: every value
    drawn, each count within 6 sigma of the uniform expectation."""
    _, port = _pair()
    gen = torch.Generator().manual_seed(0)
    n, t_len = 41 * 400, 48
    starts = np.asarray(port.draw_window_starts(n, t_len, gen))
    assert starts.min() == 0 and starts.max() == t_len - 8
    counts = np.bincount(starts, minlength=41)
    expect = n / 41
    assert (np.abs(counts - expect) < 6 * np.sqrt(expect)).all()


def test_train_step_draws_its_windows_from_the_step_counter():
    """Two models from the same weights take the same step: the draws
    come from generators seeded with the step counter."""
    lr, hr = _batch()
    runs = []
    for _ in range(2):
        _, port = _pair()
        runs.append(port.run_gradient_descent(lr, hr, 1e-3, True, True))
    assert runs[0] == runs[1]


@pytest.mark.parametrize('loss', ['MeanSquaredError', 'MeanAbsoluteError'])
def test_calc_loss_matches_jax(loss):
    jmodel, port = _pair(loss)
    _, hr = _batch()
    out = np.random.default_rng(6).random(HR_SHAPE).astype(np.float32)
    for kw in ({'train_gen': True, 'train_disc': False,
                'compute_disc': True},
               {'train_gen': False, 'train_disc': True}):
        want_loss, want = jmodel.calc_loss(hr, out, weight_gen_advers=0.01,
                                           **kw)
        got_loss, got = port.calc_loss(hr, out, weight_gen_advers=0.01,
                                       **kw)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=RTOL, err_msg=key)
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=RTOL)


@pytest.mark.parametrize('hr_days', [2, 3])
def test_val_step_matches_jax(hr_days):
    """Fixed windows of both samples; with 3 days of HR the 48 generated
    hours are reflected by 12 a side first."""
    jmodel, port = _pair()
    lr, _ = _batch()
    hr = np.random.default_rng(7).random(
        (2, 4, 4, 24 * hr_days, 1)).astype(np.float32)
    want = jmodel._get_val_step_fn()(
        jmodel.gen_params, jmodel.disc_params, jnp.asarray(lr),
        jnp.asarray(hr), jnp.float32(0.01), jax.random.PRNGKey(0))
    with torch.no_grad():
        got = port._val_step(torch.from_numpy(lr), torch.from_numpy(hr),
                             0.01)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=RTOL, err_msg=key)


def test_train_dtype_and_remat_steps():
    """A bf16 step runs the networks in bf16 with float32 master
    weights; a remat step equals the plain step (1e-5 of each loss)."""
    lr, hr = _batch()
    _, plain = _pair()
    want = plain.run_gradient_descent(lr, hr, 1e-3, True, True)
    _, remat = _pair()
    remat.train_remat = True
    got = remat.run_gradient_descent(lr, hr, 1e-3, True, True)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
    _, bf16 = _pair()
    bf16.train_dtype = 'bfloat16'
    details = bf16.run_gradient_descent(lr, hr, 1e-3, True, True)
    assert all(np.isfinite(v) for v in details.values())
    assert all(p.dtype == torch.float32 for p in bf16.gen_params)
    np.testing.assert_allclose(details['loss_gen_content'],
                               want['loss_gen_content'], rtol=0.05)


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_save_load_with_t_enhance_override(tmp_path, writer):
    """Either package reads the other's SolarCC directory, keeps the
    class and loss, and serves 24x with the override."""
    jmodel, port = _pair('MeanAbsoluteError')
    port.meta['class'] = 'SolarCC'
    d = str(tmp_path / writer)
    (port if writer == 'port' else jmodel).save(d)
    j_loaded = JaxSolarCC.load(d, t_enhance=24)
    p_loaded = SolarCC.load(d, t_enhance=24, device='cpu')
    assert p_loaded.meta['class'] == 'SolarCC'
    assert p_loaded.loss_name == 'MeanAbsoluteError'
    assert p_loaded.t_enhance == 24 and p_loaded._gen.t_enhance == 8
    lr = _batch()[0][:1, :, :, :2]
    got = p_loaded.generate(lr)
    assert got.shape == (1, 4, 4, 48, 1)
    _close(got, np.asarray(j_loaded.generate(lr)))
    assert SolarCC.load(d, device='cpu').t_enhance == 8
