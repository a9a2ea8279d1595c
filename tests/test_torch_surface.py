"""The port's ``SurfaceSpatialMetModel`` (``sup3r_tpu_torch/models/
surface.py``) and its PIL resampling (``sup3r_tpu_torch/ops/
resample.py``) against the JAX package and Pillow on the CPU.

- the resize alone against ``PIL.Image.resize`` on mode-'F' images, in
  float64, at s_enhance 2, 3 and 5 on square and non-square odd fields,
  for every filter the port builds: within 1e-6 relative (Pillow rounds
  its image to float32 between and after its passes);
- ``generate`` (temperature lapse rate, RH regression, barometric
  pressure with its clip, plain resampling of other features, the bias
  fix on and off, noise adders from the shared seeded generator) within
  1e-5 of each field's largest magnitude;
- ``train`` (the zero-intercept RH fit) and its regression inputs;
- save / load across packages, the float64 version against the float32
  one, and an unsupported method's error.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from sup3r_tpu.models.surface import (
    SurfaceSpatialMetModel as JaxSurface,
)
from sup3r_tpu.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu_torch.models import SurfaceSpatialMetModel
from sup3r_tpu_torch.ops.resample import FILTERS, resize
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR

FEATURES = ['temperature_2m', 'relativehumidity_2m', 'pressure_0m',
            'u_10m']
FIELD_TOL = 1e-5


def _fields(shape, seed=0):
    """(n, s1, s2, 4) physical-units LR fields and an LR/HR topography
    pair for ``s_enhance`` in ``shape[-1]``."""
    n, s1, s2, s = shape
    rng = np.random.default_rng(seed)
    lr = np.stack([15 + 8 * rng.standard_normal((n, s1, s2)),
                   np.clip(60 + 15 * rng.standard_normal((n, s1, s2)), 0,
                           100),
                   1e5 + 500 * rng.standard_normal((n, s1, s2)),
                   3 * rng.standard_normal((n, s1, s2))],
                  axis=-1).astype(np.float32)
    topo_hr = (800 + 400 * rng.standard_normal((s1 * s, s2 * s))).astype(
        np.float32)
    topo_lr = topo_hr.reshape(s1, s, s2, s).mean(axis=(1, 3))
    return lr, {'topography': {'steps': [{'data': topo_lr},
                                         {'data': topo_hr}]}}


def _close_fields(got, want):
    assert got.shape == want.shape
    for i in range(want.shape[-1]):
        tol = FIELD_TOL * float(np.abs(want[..., i]).max())
        err = float(np.abs(got[..., i] - want[..., i]).max())
        assert err <= tol, (i, err, tol)


@pytest.mark.parametrize('method', sorted(FILTERS))
@pytest.mark.parametrize('shape', [(7, 7), (5, 9), (11, 3)])
@pytest.mark.parametrize('s_enhance', [2, 3, 5])
def test_resize_matches_pil(method, shape, s_enhance):
    """Trap 1: Pillow's coefficient rule, truncated edges, width pass
    then height pass."""
    rng = np.random.default_rng(s_enhance)
    arr = (40 + 10 * rng.standard_normal(shape)).astype(np.float32)
    out_shape = (shape[0] * s_enhance, shape[1] * s_enhance)
    want = np.array(Image.fromarray(arr).resize(
        out_shape[::-1], resample=getattr(Image.Resampling, method)),
        dtype=np.float64)
    got = resize(torch.as_tensor(arr, dtype=torch.float64), out_shape,
                 method).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_unsupported_method_raises():
    with pytest.raises(ValueError, match='supported'):
        SurfaceSpatialMetModel(FEATURES, 2, interp_method='NEAREST',
                               device='cpu')


@pytest.mark.parametrize('s_enhance,fix_bias,method', [
    (2, True, 'LANCZOS'), (3, False, 'LANCZOS'), (5, True, 'LANCZOS'),
    (2, True, 'BICUBIC'), (3, True, 'BILINEAR')])
def test_generate_matches_jax(s_enhance, fix_bias, method):
    lr, exo = _fields((3, 6, 5, s_enhance))
    kw = dict(fix_bias=fix_bias, interp_method=method)
    want = JaxSurface(FEATURES, s_enhance, **kw).generate(
        lr, exogenous_data=exo)
    got = SurfaceSpatialMetModel(FEATURES, s_enhance, device='cpu',
                                 **kw).generate(lr, exogenous_data=exo)
    assert got.dtype == np.float32
    _close_fields(got, want)


def test_pressure_clip_matches_jax():
    """Negative downscaled pressure is clipped to 0 before the bias fix
    in both packages."""
    lr, exo = _fields((2, 4, 4, 2), seed=3)
    lr[..., 2] = 50.0
    model = SurfaceSpatialMetModel(FEATURES, 2, device='cpu')
    _close_fields(model.generate(lr, exogenous_data=exo),
                  JaxSurface(FEATURES, 2).generate(lr, exogenous_data=exo))


def test_noise_adders_match_jax():
    """The noise comes from the shared numpy generator in the JAX
    package's draw order, so a seeded run adds the same noise."""
    lr, exo = _fields((2, 4, 4, 3), seed=1)
    noise = [0.5, None, 10.0, 0.1]
    outs = []
    for rng, model in ((JAX_RNG, JaxSurface(FEATURES, 3,
                                            noise_adders=noise)),
                       (RANDOM_GENERATOR, SurfaceSpatialMetModel(
                           FEATURES, 3, noise_adders=noise, device='cpu'))):
        rng.bit_generator.state = np.random.default_rng(
            7).bit_generator.state
        outs.append(model.generate(lr, exogenous_data=exo))
    _close_fields(outs[1], outs[0])
    plain = SurfaceSpatialMetModel(FEATURES, 3, device='cpu').generate(
        lr, exogenous_data=exo)
    assert not np.allclose(outs[1][..., 0], plain[..., 0])
    np.testing.assert_array_equal(outs[1][..., 1], plain[..., 1])


def test_float64_matches_float32():
    lr, exo = _fields((2, 5, 5, 5), seed=2)
    model = SurfaceSpatialMetModel(FEATURES, 5, device='cpu')
    out32 = model.generate(lr, exogenous_data=exo)
    model.dtype = torch.float64
    hi = model.generate(lr, exogenous_data=exo, fetch=False)
    assert hi.dtype == torch.float64
    _close_fields(out32, hi.numpy())


def _smooth(rng, shape):
    s1, s2 = shape[:2]
    yy, xx = np.meshgrid(np.linspace(0, 1, s1), np.linspace(0, 1, s2),
                         indexing='ij')
    days = shape[2] if len(shape) == 3 else 1
    out = np.stack([rng.uniform(-1, 1) * np.cos(2 * np.pi * (xx + 0.3))
                    + rng.uniform(-1, 1) * np.cos(2 * np.pi * (yy + 0.7))
                    + 0.05 * rng.standard_normal((s1, s2))
                    for _ in range(days)], axis=-1)
    return out if len(shape) == 3 else out[..., 0]


def test_train_matches_jax():
    rng = np.random.default_rng(11)
    shape = (20, 20, 3)
    temp = 10 + 5 * _smooth(rng, shape)
    rh = np.clip(60 + 15 * _smooth(rng, shape), 0, 100)
    topo = 300 * (1 + _smooth(rng, shape[:2]))
    res = {'spatial': '4km', 'temporal': '60min'}
    want = JaxSurface(FEATURES, 4).train(temp, rh, topo, res)
    model = SurfaceSpatialMetModel(FEATURES, 4, device='cpu')
    got = model.train(temp, rh, topo, res)
    for g, w in ((got[3], want[3]), (got[4], want[4])):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= FIELD_TOL * np.abs(w).max()
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-4)
    assert got[2].intercept_ == 0.0
    np.testing.assert_allclose(got[2].predict(got[3][:5]),
                               got[3][:5] @ got[2].coef_)
    assert model.meta['input_resolution'] == res
    with pytest.raises(AssertionError):
        model.train(temp[..., 0], rh, topo, res)


def test_save_load_across_packages(tmp_path):
    lr, exo = _fields((2, 4, 6, 2), seed=4)
    kw = dict(noise_adders=None, w_delta_temp=-2.5, w_delta_topo=-0.02,
              interp_method='BICUBIC', fix_bias=False,
              input_resolution={'spatial': '12km', 'temporal': '60min'})
    SurfaceSpatialMetModel(FEATURES, 2, device='cpu', **kw).save(
        str(tmp_path / 'port'))
    JaxSurface(FEATURES, 2, **kw).save(str(tmp_path / 'jax'))
    from_jax = SurfaceSpatialMetModel.load(str(tmp_path / 'jax'),
                                           device='cpu')
    to_jax = JaxSurface.load(str(tmp_path / 'port'))
    assert from_jax.meta == to_jax.meta
    _close_fields(from_jax.generate(lr, exogenous_data=exo),
                  to_jax.generate(lr, exogenous_data=exo))
