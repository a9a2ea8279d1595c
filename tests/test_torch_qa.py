"""The port's QA (``sup3r_tpu_torch.qa``) against the JAX package's on
the fixtures of tests/solar_qa/test_qa_depth.py and test_solar_qa.py:
``Sup3rQa`` on ``device='cpu'`` over H5 and NetCDF outputs, ws / wd from
u / v sources, ``subsample`` and per-feature methods, explicit source
features and output names, ``bias_correct_method`` and ``export``. Each
error array is held to the JAX package's within 1e-4 of its largest
magnitude, and the exported files to the JAX package's at the same bar.
Every function of ``qa/utilities.py`` gives the JAX package's values."""

import h5py
import numpy as np
import pandas as pd
import pytest

import sup3r_tpu.qa.utilities as jax_qu
import sup3r_tpu_torch.qa.utilities as port_qu
from sup3r_tpu.postprocessing.writers import OutputHandlerH5, OutputHandlerNC
from sup3r_tpu.preprocessing.loaders import LoaderNC
from sup3r_tpu.qa import Sup3rQa as JaxQa
from sup3r_tpu.utilities.test_helpers import (
    make_fake_h5_file,
    make_fake_nc_file,
)
from sup3r_tpu_torch.qa import Sup3rQa
from tests.solar_qa.test_qa_depth import _enhanced

RTOL = 1e-4


def _close(got, want, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = RTOL * max(float(np.nanmax(np.abs(want))), 1e-6)
    err = float(np.nanmax(np.abs(got - want)))
    assert err <= tol, (what, err, tol)


def _grid12():
    lat = np.linspace(40.0, 39.0, 12)
    lon = np.linspace(-105.5, -104.3, 12)
    return np.dstack(np.meshgrid(lat, lon, indexing='ij'))


@pytest.fixture
def sources(tmp_path):
    """A u / v source, its perturbed 2x / 2x enhancement written as H5
    (the writer stores ws / wd) and as NetCDF (raw u / v)."""
    src_fp = make_fake_nc_file(str(tmp_path / 'src.nc'), (6, 6, 8),
                               ['u100', 'v100'])
    src = LoaderNC(src_fp).data
    rng = np.random.default_rng(3)
    hr = np.stack([_enhanced(np.asarray(src[f]), 2, 2)
                   for f in ('u_100m', 'v_100m')], axis=-1)
    hr = (hr + rng.normal(0, 0.3, hr.shape)).astype(np.float32)
    times = pd.date_range('2023-01-01', periods=16, freq='30min')
    out = {}
    for ext, handler in (('h5', OutputHandlerH5), ('nc', OutputHandlerNC)):
        out[ext] = str(tmp_path / f'out_000000_000000.{ext}')
        handler._write_output(hr.copy(), ['u_100m', 'v_100m'], _grid12(),
                              times, out[ext])
    return src_fp, out, tmp_path


def _run_both(src_fp, out_fp, qa_dir=None, **kwargs):
    """Both packages' errors (and exported files) on the same call."""
    results = []
    for name, cls, extra in (('port', Sup3rQa, {'device': 'cpu'}),
                             ('jax', JaxQa, {})):
        qa_fp = None if qa_dir is None else str(qa_dir / f'{name}_qa.h5')
        qa = cls(src_fp, out_fp, qa_fp=qa_fp, **kwargs, **extra)
        results.append((qa.run(), qa_fp))
        qa.close()
    (port, port_fp), (jax, jax_fp) = results
    assert set(port) == set(jax)
    for k in jax:
        assert port[k].dtype == np.float32
        _close(port[k], jax[k], k)
    if qa_dir is not None:
        with h5py.File(port_fp) as fp, h5py.File(jax_fp) as fj:
            assert set(fp) == set(fj)
            for k in fj:
                _close(fp[k][:], fj[k][:], k)
    return port


@pytest.mark.parametrize('ext,features,method', [
    ('h5', ['windspeed_100m'], 'average'),
    ('h5', ['winddirection_100m'], 'subsample'),
    ('h5', ['windspeed_100m', 'winddirection_100m'],
     ['average', 'subsample']),
    ('h5', None, 'max'),
    ('nc', ['u_100m', 'v_100m'], 'average'),
    ('nc', None, ['min', 'total']),
])
def test_qa_matches_jax(sources, ext, features, method):
    """The H5 output holds ws / wd (from the u / v source); the NetCDF
    output raw u / v."""
    src_fp, out, tmp_path = sources
    errors = _run_both(src_fp, out[ext], qa_dir=tmp_path, s_enhance=2,
                       t_enhance=2, temporal_coarsening_method=method,
                       features=features)
    assert all(np.isfinite(v).all() for v in errors.values())


def test_qa_nc_uv_exact_enhancement(tmp_path):
    """A constant enhancement of the source re-coarsens onto it."""
    src_fp = make_fake_nc_file(str(tmp_path / 'src.nc'), (6, 6, 8),
                               ['u100', 'v100'])
    src = LoaderNC(src_fp).data
    hr = np.stack([_enhanced(np.asarray(src[f]), 2, 2)
                   for f in ('u_100m', 'v_100m')], axis=-1)
    out_fp = str(tmp_path / 'out.nc')
    OutputHandlerNC._write_output(
        hr.astype(np.float32), ['u_100m', 'v_100m'], _grid12(),
        pd.date_range('2023-01-01', periods=16, freq='30min'), out_fp)
    errors = _run_both(src_fp, out_fp, qa_dir=tmp_path, s_enhance=2,
                       t_enhance=2, features=['u_100m', 'v_100m'])
    assert abs(errors['u_100m_error']).max() < 1e-4


def test_qa_source_features_output_names(tmp_path):
    src_fp = make_fake_nc_file(str(tmp_path / 'src.nc'), (6, 6, 8),
                               ['rsds'])
    hr = _enhanced(np.asarray(LoaderNC(src_fp).data['rsds']), 2, 2)
    out_fp = str(tmp_path / 'out.nc')
    OutputHandlerNC._write_output(
        hr[..., None].astype(np.float32), ['ghi'], _grid12(),
        pd.date_range('2023-01-01', periods=16, freq='30min'), out_fp)
    errors = _run_both(src_fp, out_fp, qa_dir=tmp_path, s_enhance=2,
                       t_enhance=2, temporal_coarsening_method=['average'],
                       features='ghi', source_features='rsds',
                       output_names='ghi_qa')
    assert set(errors) == {'ghi_qa_error'}
    np.testing.assert_allclose(errors['ghi_qa_error'], 0, atol=1e-4)
    _run_both(src_fp, out_fp, qa_dir=tmp_path, s_enhance=2, t_enhance=2,
              features='ghi', source_features='rsds', save_sources=False)
    with h5py.File(tmp_path / 'port_qa.h5') as f:
        assert set(f) == {'latitude', 'longitude', 'ghi_error'}


def test_qa_bias_corrected_source(sources):
    src_fp, out, _ = sources
    kwargs = {'u_100m': {'scalar': 2.0, 'adder': 0.0},
              'v_100m': {'scalar': 2.0, 'adder': 0.5}}
    _run_both(src_fp, out['h5'], s_enhance=2, t_enhance=2,
              features=['windspeed_100m'],
              bias_correct_method='global_linear_bc',
              bias_correct_kwargs=kwargs)


def test_qa_shape_mismatch_raises(tmp_path):
    src = make_fake_nc_file(str(tmp_path / 'src.nc'), (4, 4, 6),
                            ['u100'], freq='D')
    out = make_fake_h5_file(
        str(tmp_path / 'out.h5'), (8, 8, 24), ['u_100m'], freq='h',
        lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3))
    qa = Sup3rQa(src, out, s_enhance=2, t_enhance=2,
                 features=['u_100m'], device='cpu')
    with pytest.raises(RuntimeError, match='shape'):
        qa.run()
    right = Sup3rQa(src, out, s_enhance=2, t_enhance=4,
                    features=['u_100m'], device='cpu')
    want = JaxQa(src, out, s_enhance=2, t_enhance=4, features=['u_100m'])
    _close(right.run()['u_100m_error'], want.run()['u_100m_error'])


def test_qa_without_card_raises(sources, monkeypatch):
    """The default device is the card: with none, QA raises."""
    import torch

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    src_fp, out, _ = sources
    with pytest.raises(RuntimeError, match='CUDA'):
        Sup3rQa(src_fp, out['nc'], s_enhance=2, t_enhance=2)


def _fields(seed=0, shape=(16, 16, 32)):
    rng = np.random.default_rng(seed)
    return rng.random(shape), rng.random(shape)


@pytest.mark.parametrize('name,args,kwargs', [
    ('frequency_spectrum', ('u',), {}),
    ('frequency_spectrum', ('u',), {'f_range': [1 / 48, 1 / 2]}),
    ('tke_frequency_spectrum', ('u', 'v'), {}),
    ('tke_frequency_spectrum', ('u', 'v'), {'f_range': [0.01, 0.5]}),
    ('wavenumber_spectrum', ('u',), {}),
    ('wavenumber_spectrum', ('u',), {'axis': 1}),
    ('wavenumber_spectrum', ('u',), {'axis': None, 'x_range': [0.1, 2]}),
    ('wavenumber_spectrum', ('u0',), {'x_range': [0.1, 2.0]}),
    ('tke_wavenumber_spectrum', ('u0', 'v0'), {}),
    ('tke_wavenumber_spectrum', ('u', 'v'), {'axis': None}),
    ('direct_dist', ('u',), {}),
    ('direct_dist', ('wd',), {'period': 360, 'percentile': 100,
                              'bins': 4}),
    ('direct_dist', ('u',), {'diff_max': 0.5, 'scale': 2,
                             'interpolate': True}),
    ('gradient_dist', ('u',), {}),
    ('gradient_dist', ('wd',), {'period': 360, 'percentile': 100}),
    ('time_derivative_dist', ('u',), {'t_steps': 3}),
    ('time_derivative_dist', ('wd',), {'period': 360, 'percentile': 100}),
    ('continuous_dist', ('gaps',), {'bins': 3, 'range': (0, 2)}),
    ('continuous_dist', ('gaps',), {'bins': 3, 'range': (0, 2),
                                    'interpolate': True}),
    ('continuous_dist', ('ramp',), {}),
])
def test_qa_utilities_match_jax(name, args, kwargs):
    u, v = _fields()
    wd = np.random.default_rng(1).random((4, 6, 20))
    wd[..., ::2] += 357.0
    wd[:, ::2] += 1.0
    arrays = {'u': u, 'v': v, 'u0': u[..., 0], 'v0': v[..., 0], 'wd': wd,
              'gaps': np.array([0.0] * 10 + [2.0] * 10),
              'ramp': np.linspace(0, 1, 11)}
    got = getattr(port_qu, name)(*[arrays[a] for a in args], **kwargs)
    want = getattr(jax_qu, name)(*[arrays[a] for a in args], **kwargs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
