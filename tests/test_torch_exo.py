"""The port's exogenous data (``sup3r_tpu_torch/preprocessing/exo.py``)
against the JAX package's on the same inputs: ``ExoData``'s routing and
chunking, topography rasters from an H5 and a NetCDF3 source and ``sza``
rasters within 1e-6, the cache file's name and reading a cache the JAX
package wrote, and ``ExoDataHandler``'s steps and enhancements for a
2-step chain."""

import copy

import numpy as np
import pytest

from sup3r_tpu.preprocessing import exo as jexo
from sup3r_tpu.utilities.test_helpers import (
    make_fake_h5_file,
    make_fake_nc_file,
)
from sup3r_tpu_torch.preprocessing import exo
from sup3r_tpu_torch.utilities.test_helpers import make_fake_topo_nc_file

TOL = 1e-6


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('exo')
    lr = make_fake_nc_file(str(root / 'lr.nc'), (8, 8, 4), ['u100'])
    h5 = make_fake_h5_file(str(root / 'topo.h5'), (40, 40, 2),
                           ['windspeed_10m'], lat_range=(40.2, 38.8),
                           lon_range=(-105.7, -104.1))
    nc = make_fake_topo_nc_file(str(root / 'topo.nc'), (40, 40))
    return {'lr': lr, 'h5': h5, 'nc': nc}


def _steps():
    rng = np.random.default_rng(0)
    return {'topography': {'steps': [
        {'model': 0, 'combine_type': 'input', 's_enhance': 1,
         't_enhance': 1, 'data': rng.random((8, 8, 1))},
        {'model': 0, 'combine_type': 'layer', 's_enhance': 2,
         't_enhance': 1, 'data': rng.random((16, 16, 1))},
        {'model': 1, 'combine_type': 'layer', 's_enhance': 2,
         't_enhance': 3, 'data': rng.random((16, 16, 12, 1))},
        {'model': 2, 'combine_type': 'output', 's_enhance': 4,
         't_enhance': 3, 'data': rng.random((32, 32, 12, 1))}]},
        'sza': {'steps': [
            {'model': 1, 'combine_type': 'input', 's_enhance': 2,
             't_enhance': 1, 'data': rng.random((16, 16, 4, 1))}]}}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for feat in want:
        gs, ws = got[feat]['steps'], want[feat]['steps']
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert {k: v for k, v in g.items() if k != 'data'} == {
                k: v for k, v in w.items() if k != 'data'}
            np.testing.assert_array_equal(g['data'], w['data'])


def test_exo_data_routing_matches_jax():
    """``get_model_step_exo``, ``split``, ``get_combine_type_data`` and
    ``get_chunk`` give the JAX package's records."""
    port, jax_ = exo.ExoData(_steps()), jexo.ExoData(_steps())
    for step in range(3):
        _assert_same(port.get_model_step_exo(step),
                     jax_.get_model_step_exo(step))
    for split in ([1], [2], [1, 2]):
        got = exo.ExoData(copy.deepcopy(_steps())).split(split)
        want = jexo.ExoData(copy.deepcopy(_steps())).split(split)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    np.testing.assert_array_equal(
        port.get_combine_type_data('topography', 'layer', model_step=1),
        jax_.get_combine_type_data('topography', 'layer', model_step=1))
    sl = [slice(2, 6), slice(1, 7), slice(1, 3)]
    _assert_same(port.get_chunk(sl), jax_.get_chunk(sl))
    with pytest.raises(AssertionError):
        port.get_combine_type_data('sza', 'layer')


@pytest.mark.parametrize('source', ['h5', 'nc'])
@pytest.mark.parametrize('s_enhance', [1, 2, 3])
def test_topography_raster_matches_jax(files, tmp_path, source, s_enhance):
    kw = dict(file_paths=files['lr'], source_file=files[source],
              feature='topography', s_enhance=s_enhance)
    port = exo.ExoRasterizer(cache_dir=str(tmp_path / 'port'), **kw)
    jax_ = jexo.ExoRasterizer(cache_dir=str(tmp_path / 'jax'), **kw)
    got, want = port.data, jax_.data
    assert got.shape == want.shape == (8 * s_enhance, 8 * s_enhance, 1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(
        want).max())
    assert (port.cache_file.split('/')[-1]
            == jax_.cache_file.split('/')[-1])


def test_sza_raster_matches_jax(files, tmp_path):
    kw = dict(file_paths=files['lr'], feature='sza', s_enhance=2,
              t_enhance=3, cache_dir=str(tmp_path))
    got = exo.SzaRasterizer(**kw).data
    want = jexo.SzaRasterizer(**kw).data
    assert got.shape == want.shape == (16, 16, 12, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * 180)


def test_port_reads_the_jax_cache(files, tmp_path, monkeypatch):
    """The JAX package writes the cache; the port finds the same file
    and reads it without rasterizing."""
    kw = dict(file_paths=files['lr'], source_file=files['nc'],
              feature='topography', s_enhance=2, cache_dir=str(tmp_path))
    jax_ = jexo.ExoRasterizer(**kw)
    want = jax_.data
    port = exo.ExoRasterizer(**kw)
    assert port.cache_file == jax_.cache_file
    monkeypatch.setattr(exo.ExoRasterizer, 'get_data',
                        lambda self: pytest.fail('rasterized again'))
    np.testing.assert_array_equal(port.data, want)


def test_default_cache_dir_follows_the_environment(files, tmp_path,
                                                   monkeypatch):
    kw = dict(file_paths=files['lr'], source_file=files['nc'],
              feature='topography')
    monkeypatch.setenv('SUP3R_TPU_EXO_CACHE_DIR', str(tmp_path / 'env'))
    assert exo.ExoRasterizer(**kw).cache_dir == str(tmp_path / 'env')
    assert exo.ExoRasterizer(cache_dir='x', **kw).cache_dir == 'x'
    monkeypatch.delenv('SUP3R_TPU_EXO_CACHE_DIR')
    assert exo.ExoRasterizer(**kw).cache_dir == './exo_cache'


class _FakeModel:
    def __init__(self, s, t, lr, hr_exo=(), out=()):
        self.s_enhance = s
        self.t_enhance = t
        self.lr_features = list(lr)
        self.hr_exo_features = list(hr_exo)
        self.hr_out_features = list(out)
        self.obs_features = []


class _Chain:
    """Two steps, each taking ``feature`` as an input channel and in a
    mid-network layer."""

    def __init__(self, feature='topography'):
        self.models = [
            _FakeModel(2, 1, ['u_100m', feature], hr_exo=[feature],
                       out=['u_100m']),
            _FakeModel(3, 4, ['u_100m', feature], hr_exo=[feature],
                       out=['u_100m'])]


@pytest.mark.parametrize('feature', ['topography', 'sza'])
def test_exo_handler_steps_match_jax(files, tmp_path, feature):
    """A 2-step chain's steps, enhancements and rasters: input at 1x and
    2x, layer at 2x and 6x / 4x."""
    chain = _Chain(feature)
    assert exo.ExoDataHandler.get_exo_steps(
        feature, chain.models) == jexo.ExoDataHandler.get_exo_steps(
        feature, chain.models)
    kw = dict(model=chain, source_file=files['h5'])
    got = exo.ExoDataHandler(files['lr'], feature,
                             cache_dir=str(tmp_path / 'port'), **kw).data
    want = jexo.ExoDataHandler(files['lr'], feature,
                               cache_dir=str(tmp_path / 'jax'), **kw).data
    steps = got[feature]['steps']
    assert [(s['model'], s['combine_type'], s['s_enhance'],
             s['t_enhance']) for s in steps] == [
        (0, 'input', 1, 1), (0, 'layer', 2, 1), (1, 'input', 2, 1),
        (1, 'layer', 6, 4)]
    for g, w in zip(steps, want[feature]['steps']):
        assert g['data'].shape == w['data'].shape
        np.testing.assert_allclose(
            g['data'], w['data'], rtol=0,
            atol=TOL * max(1, np.abs(w['data']).max()))


def test_observation_rasters_are_not_ported(files):
    """Observation rasters are ported now (tests/test_torch_with_obs.py
    holds them to the JAX package): ``*_obs`` features go to the sparse,
    time-dependent ``ObsRasterizer``, which keeps its NaNs."""
    assert exo.ExoDataHandler._rasterizer_class(
        'u_10m_obs') is exo.ObsRasterizer
    assert exo.ObsRasterizer.TIME_DEPENDENT
    assert not exo.ObsRasterizer.FILL_NANS_DEFAULT
