"""The port's inference modes (``Sup3rGan.inference_mode``,
``inference_subpixel_tail``, ``inference_dtype``) against the JAX
package's, after tests/forward_pass/test_fast_mode.py and
tests/models/test_subpixel.py: the mode flags; the full-width flagship on
a (2, 6, 6, 4, 2) input with the same weights in both packages, in the
'custom' mode (subpixel tail, float32 body: within 1e-4 of the exact
output and of the JAX package's) and in fast mode (subpixel tail, bf16
body: within 0.04 of the largest magnitude of the JAX package's fast
output and of the port's own exact output, the documented budget of
docs/PERFORMANCE.md "Fast inference mode"); the chunked ``ForwardPass``
in fast mode on the fixture of test_fast_mode.py, whose stitched outputs
stay within 0.05 of the exact pass on the data scale in both packages;
and the strategy resetting a cached model's mode."""

import os
import warnings

import h5py
import jax
import numpy as np
import pytest
import torch

from sup3r_tpu.configs import get_config
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
from sup3r_tpu_torch.models import Sup3rGan, params_from_jax
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from tests.forward_pass.test_forward_pass import _save_model, _st_gen_config

torch.set_num_threads(1)

LR_SHAPE = (2, 6, 6, 4, 2)
FAST_BUDGET = 0.04
FWP_BUDGET = 0.05


def _tiny_gan():
    gen = [{'class': 'Conv2D', 'filters': 8, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'},
           {'class': 'SpatialExpansion', 'spatial_mult': 2},
           {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'}]
    disc = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    return Sup3rGan(gen, disc, device='cpu')


def test_inference_mode_flags():
    m = _tiny_gan()
    assert m.inference_mode == 'exact'
    m.inference_mode = 'fast'
    assert m.inference_subpixel_tail is True
    assert m.inference_dtype == 'bfloat16'
    assert m.inference_mode == 'fast'
    m.inference_mode = 'exact'
    assert m.inference_subpixel_tail is False
    assert m.inference_dtype is None
    # hand-set combinations report 'custom'
    m.inference_dtype = 'bfloat16'
    assert m.inference_mode == 'custom'
    m.inference_mode = 'exact'
    m.inference_subpixel_tail = True
    assert m.inference_mode == 'custom'
    with pytest.raises(ValueError, match='exact.*fast'):
        m.inference_mode = 'turbo'


@pytest.fixture(scope='module')
def flagship():
    """(JAX model, port model with the JAX weights, input, each
    package's exact output)."""
    gen = get_config('spatiotemporal/gen_3x_4x_2f')
    disc = get_config('spatiotemporal/disc_test')
    jmodel = JaxGan(gen, disc)
    jmodel.init_weights((1, *LR_SHAPE[1:]), (1, 18, 18, 16, 2))
    model = Sup3rGan(gen, disc, device='cpu')
    model.init_weights((1, *LR_SHAPE[1:]), (1, 18, 18, 16, 2))
    params_from_jax(model.generator,
                    jax.tree.map(np.asarray, jmodel.gen_params))
    lr = np.random.default_rng(3).standard_normal(LR_SHAPE).astype(
        np.float32)
    exact = [m.generate(lr, norm_in=False, un_norm_out=False)
             for m in (jmodel, model)]
    return jmodel, model, lr, exact


def _generate(models, lr, subpixel_tail, dtype):
    outs = []
    for m in models:
        m.inference_subpixel_tail = subpixel_tail
        m.inference_dtype = dtype
        try:
            outs.append(m.generate(lr, norm_in=False, un_norm_out=False))
        finally:
            m.inference_mode = 'exact'
    return outs


def test_custom_mode_fp32_subpixel_tail(flagship):
    """Tail on, float32 body: the subpixel conv is float32 (TF32 off on
    the card), so it matches the exact route at the fp32 parity bar."""
    jmodel, model, lr, (jexact, exact) = flagship
    want, got = _generate((jmodel, model), lr, True, None)
    assert model.inference_mode == 'exact'
    assert got.dtype == np.float32 and got.shape == exact.shape
    scale = float(np.abs(exact).max())
    assert float(np.abs(got - exact).max()) <= 1e-4 * scale
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    np.testing.assert_allclose(exact, jexact, rtol=0, atol=1e-4 * scale)


def test_fast_mode_within_budget(flagship):
    jmodel, model, lr, (_, exact) = flagship
    for m in (jmodel, model):
        m.inference_mode = 'fast'
    try:
        want, got = (m.generate(lr, norm_in=False, un_norm_out=False)
                     for m in (jmodel, model))
    finally:
        for m in (jmodel, model):
            m.inference_mode = 'exact'
    assert got.dtype == np.float32 and got.shape == exact.shape
    assert np.isfinite(got).all()
    err_jax = float(np.abs(got - want).max()) / float(np.abs(want).max())
    err_exact = float(np.abs(got - exact).max()) / float(
        np.abs(exact).max())
    assert err_jax <= FAST_BUDGET, err_jax
    assert err_exact <= FAST_BUDGET, err_exact
    # a genuinely different compute path
    assert err_exact > 0


def test_unfused_bf16_body(flagship):
    """``inference_fuse=False`` with ``inference_dtype``: the plain
    network in bf16, as the JAX package's ``_get_gen_apply`` runs it."""
    jmodel, model, lr, (_, exact) = flagship
    for m in (jmodel, model):
        m.inference_fuse = False
    try:
        want, got = _generate((jmodel, model), lr, False, 'bfloat16')
    finally:
        for m in (jmodel, model):
            m.inference_fuse = True
    scale = float(np.abs(exact).max())
    assert got.dtype == np.float32
    assert 0 < float(np.abs(got - exact).max()) <= FAST_BUDGET * scale
    assert float(np.abs(got - want).max()) <= FAST_BUDGET * scale


def _run_mode(package, input_file, model_dir, out_dir, mode):
    """One forward pass of test_fast_mode.py's fixture to H5 chunk files;
    returns {file: {feature: physical values}}."""
    os.makedirs(out_dir)
    Strategy, Fwp, mkw = (
        (ForwardPassStrategy, ForwardPass,
         {'model_dir': model_dir, 'device': 'cpu'}) if package == 'port'
        else (JaxStrategy, JaxForwardPass, {'model_dir': model_dir}))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        strategy = Strategy(
            file_paths=input_file, model_class='Sup3rGan',
            model_kwargs=mkw, fwp_chunk_shape=(6, 6, 8), spatial_pad=2,
            temporal_pad=2,
            out_pattern=os.path.join(str(out_dir), 'chunk_{file_id}.h5'),
            inference_mode=mode)
        Fwp.run(strategy, 0)
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with h5py.File(os.path.join(str(out_dir), name), 'r') as f:
            out[name] = {
                feat: f[feat][:].astype(np.float64)
                / f[feat].attrs.get('scale_factor', 1.0)
                for feat in ('windspeed_100m', 'winddirection_100m')}
    return out


@pytest.mark.parametrize('package', ['port', 'jax'])
def test_forward_pass_fast_mode_budget(tmp_path, package):
    """test_fast_mode.py's budget through the chunked forward pass: every
    stitched chunk within 0.05 of the exact pass on the data scale,
    direction within 2 degrees where the speed is not negligible."""
    input_file = make_fake_nc_file(str(tmp_path / 'in.nc'), (12, 12, 16),
                                   ['u100', 'v100'])
    model_dir, _ = _save_model(tmp_path, _st_gen_config(), 3, 4,
                               is_5d=True)
    exact = _run_mode(package, input_file, model_dir, tmp_path / 'exact',
                      'exact')
    fast = _run_mode(package, input_file, model_dir, tmp_path / 'fast',
                     'fast')
    assert set(exact) == set(fast) and exact
    engaged = False
    for name, feats in exact.items():
        ws_e = feats['windspeed_100m']
        ws_f = fast[name]['windspeed_100m']
        scale = max(1.0, float(np.abs(ws_e).max()))
        err = float(np.abs(ws_f - ws_e).max())
        assert err <= FWP_BUDGET * scale, (name, err, scale)
        engaged = engaged or err > 0.0
        wd_e = feats['winddirection_100m']
        wd_f = fast[name]['winddirection_100m']
        circ = np.abs((wd_f - wd_e + 180.0) % 360.0 - 180.0)
        strong = ws_e > 0.2 * scale
        assert circ[strong].max() <= 2.0, (name, circ[strong].max())
    assert engaged, 'fast mode produced bit-identical outputs'


def test_strategy_resets_cached_model_mode(tmp_path):
    """The strategy applies its mode to the loaded model on every call,
    a cached instance included."""
    input_file = make_fake_nc_file(str(tmp_path / 'in.nc'), (12, 12, 16),
                                   ['u100', 'v100'])
    model_dir, _ = _save_model(tmp_path, _st_gen_config(), 3, 4,
                               is_5d=True)
    kw = dict(file_paths=input_file,
              model_kwargs={'model_dir': model_dir, 'device': 'cpu'},
              fwp_chunk_shape=(6, 6, 8), spatial_pad=2, temporal_pad=2,
              out_pattern=None)
    fast = ForwardPassStrategy(inference_mode='fast', **kw)
    model = fast.get_model()
    assert model.inference_mode == 'fast'
    model.inference_dtype = None
    assert model.inference_mode == 'custom'
    assert fast.get_model() is model
    assert model.inference_mode == 'fast'
    exact = ForwardPassStrategy(inference_mode='exact', **kw)
    assert exact.get_model().inference_mode == 'exact'
    assert fast.get_model().inference_mode == 'fast'
