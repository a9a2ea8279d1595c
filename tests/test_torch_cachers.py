"""The port's feature cache (``sup3r_tpu_torch.postprocessing.cachers``
and ``DataHandler(cache_kwargs=...)``) against the JAX package's on the
cases of tests/data_handlers/test_cachers.py: the same dataset cached by
both packages gives files with equal datasets (dimension scales
included) and attributes; each package reloads the other's cache to the
same arrays, coordinates and times; a handler's write then reload holds
the JAX handler's data."""

import os

import h5py
import numpy as np
import pandas as pd
import pytest

from sup3r_tpu.postprocessing import cachers as jax_cachers
from sup3r_tpu.preprocessing import data_handlers as jax_dh
from sup3r_tpu.preprocessing.grid import GridDataset as JaxGridDataset
from sup3r_tpu.utilities.test_helpers import (
    make_fake_h5_file,
    make_fake_nc_file,
)
from sup3r_tpu_torch.postprocessing import cachers as port_cachers
from sup3r_tpu_torch.preprocessing import data_handlers as port_dh
from sup3r_tpu_torch.preprocessing.grid import GridDataset


def _dsets(shape=(6, 5, 8), features=('u_100m', 'v_100m')):
    """The same dataset as the port's and the JAX package's container."""
    rng = np.random.default_rng(0)
    data = rng.random((*shape, len(features))).astype(np.float32)
    lat = np.linspace(40, 39, shape[0])
    lon = np.linspace(-105, -104, shape[1])
    lat_lon = np.dstack(np.meshgrid(lat, lon, indexing='ij'))
    ti = pd.date_range('2023-01-01', periods=shape[2], freq='h')
    return (GridDataset(data, list(features), lat_lon=lat_lon,
                        time_index=ti.values),
            JaxGridDataset(data, list(features), lat_lon=lat_lon,
                           time_index=ti))


def _assert_files_equal(got, want):
    with h5py.File(got, 'r') as fg, h5py.File(want, 'r') as fw:
        assert set(fg) == set(fw)
        for k in fw:
            np.testing.assert_array_equal(fg[k][:], fw[k][:], err_msg=k)
            assert fg[k].dtype == fw[k].dtype
            assert fg[k].chunks == fw[k].chunks
            assert ({a for a in fg[k].attrs if a != 'DIMENSION_LIST'}
                    == {a for a in fw[k].attrs if a != 'DIMENSION_LIST'})
            for a, v in fw[k].attrs.items():
                if a not in ('DIMENSION_LIST', 'REFERENCE_LIST'):
                    np.testing.assert_equal(fg[k].attrs[a], v)
            if 'DIMENSION_LIST' in fw[k].attrs:
                assert ([fg[r[0]].name for r in fg[k].attrs[
                    'DIMENSION_LIST']] == [fw[r[0]].name for r in fw[k]
                                           .attrs['DIMENSION_LIST']])


def _assert_loaded_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got.data),
                                  np.asarray(want.data))
    assert list(got.features) == list(want.features)
    np.testing.assert_array_equal(got.lat_lon, want.lat_lon)
    np.testing.assert_array_equal(np.asarray(got.time_index.values),
                                  np.asarray(want.time_index.values))


def _cache_both(tmp_path, ext, kwargs, shape=(6, 5, 8),
                features=('u_100m', 'v_100m')):
    """Cache with both packages; returns the two patterns after checking
    the files and the cross reloads."""
    port_data, jax_data = _dsets(shape, features)
    patterns = {}
    for name, mod, data in (('port', port_cachers, port_data),
                            ('jax', jax_cachers, jax_data)):
        d = tmp_path / name
        d.mkdir()
        patterns[name] = str(d / ('cache_{feature}.' + ext))
        out = mod.Cacher(data, {'cache_pattern': patterns[name],
                                **kwargs}).out_files
        assert out == [patterns[name].format(feature=f) for f in features]
    for f in features:
        _assert_files_equal(patterns['port'].format(feature=f),
                            patterns['jax'].format(feature=f))
    for pattern in patterns.values():
        _assert_loaded_equal(
            port_cachers.load_cached(pattern, list(features)),
            jax_cachers.load_cached(pattern, list(features)))
    return patterns, port_data


@pytest.mark.parametrize('ext', ['h5', 'nc'])
def test_cache_roundtrip_matches_jax(tmp_path, ext):
    patterns, data = _cache_both(tmp_path, ext, {})
    back = port_cachers.load_cached(patterns['port'], ['u_100m', 'v_100m'])
    np.testing.assert_allclose(back.data, data.data, rtol=1e-6)
    np.testing.assert_allclose(back.lat_lon, data.lat_lon, rtol=1e-6)
    assert back.time_index.equals(data.time_index)
    again = port_cachers.load_cached(patterns['port'], 'all')
    assert sorted(again.features) == ['u_100m', 'v_100m']
    assert port_cachers.load_cached(patterns['port'], ['u_10m']) is None


@pytest.mark.parametrize('ext', ['h5', 'nc'])
def test_cache_chunk_specs_match_jax(tmp_path, ext):
    chunks = {'u_100m': {'south_north': 3, 'west_east': 2, 'time': 4},
              'v_100m': {'south_north': 6, 'west_east': 5, 'time': 8}}
    patterns, _ = _cache_both(tmp_path, ext, {'chunks': chunks})
    with h5py.File(patterns['port'].format(feature='u_100m'), 'r') as f:
        assert f['u_100m'].chunks == (3, 2, 4)


@pytest.mark.parametrize('chunks', [
    (100, 5, 5), {'south_north': 2, 'west_east': 3, 'time': 4},
    {'time': 4}, None, 'auto',
    {'U_100m': {'south_north': 1, 'west_east': 1, 'time': 1}}])
def test_parse_chunks_matches_jax(chunks):
    for shape in ((10, 10, 20), (1, 2, 3)):
        assert (port_cachers.parse_chunks('u_100m', chunks, shape)
                == jax_cachers.parse_chunks('u_100m', chunks, shape))


@pytest.mark.parametrize('ext', ['h5', 'nc'])
def test_scale_factor_encoding_matches_jax(tmp_path, ext):
    attrs = {'u_100m': {'scale_factor': 0.001, 'dtype': 'int16'}}
    patterns, data = _cache_both(tmp_path, ext, {'attrs': attrs},
                                 features=('u_100m',))
    with h5py.File(patterns['port'].format(feature='u_100m'), 'r') as f:
        assert f['u_100m'].dtype == np.int16
        assert f['u_100m'].attrs['scale_factor'] == 0.001
    back = port_cachers.load_cached(patterns['port'], ['u_100m'])
    np.testing.assert_allclose(back.data, data.data, atol=6e-4)


def test_max_workers_parallel_write(tmp_path):
    _cache_both(tmp_path, 'h5', {'max_workers': 4}, shape=(8, 7, 12),
                features=('u_100m', 'v_100m', 'u_10m', 'v_10m'))


def test_overwrite_semantics(tmp_path):
    data, _ = _dsets(features=('u_100m',))
    pattern = str(tmp_path / 'cache_{feature}.h5')
    fp = pattern.format(feature='u_100m')
    port_cachers.Cacher(data, {'cache_pattern': pattern})
    mtime = os.path.getmtime(fp)
    stale = GridDataset(np.zeros_like(data.data), data.features,
                        lat_lon=data.lat_lon, time_index=data.time_index)
    port_cachers.Cacher(stale, {'cache_pattern': pattern})  # skipped
    back = port_cachers.load_cached(pattern, ['u_100m'])
    np.testing.assert_allclose(back.data, data.data, rtol=1e-6)
    port_cachers.Cacher(stale, {'cache_pattern': pattern,
                                'overwrite': True})
    back = port_cachers.load_cached(pattern, ['u_100m'])
    assert float(np.abs(back.data).max()) == 0.0
    assert os.path.getmtime(fp) >= mtime


def test_bad_pattern_raises(tmp_path):
    data, _ = _dsets(features=('u_100m',))
    with pytest.raises(AssertionError, match='.h5 or .nc'):
        port_cachers.Cacher(
            data, {'cache_pattern': str(tmp_path / 'c_{feature}.zarr')})
    with pytest.raises(AssertionError, match='feature'):
        port_cachers.Cacher(data, {'cache_pattern': str(tmp_path / 'c.h5')})


def _handlers_both(cls_name, fp, tmp_path, **kwargs):
    """The JAX handler, the port's first (writing) handler and the
    port's second (cache hit) handler on the same kwargs; the two
    packages cache into directories of their own."""
    out = []
    for name, mod in (('jax', jax_dh), ('port', port_dh)):
        kw = dict(kwargs)
        ck = kw.pop('cache_kwargs')
        d = tmp_path / f'cache_{name}'
        ck = dict(ck, cache_pattern=str(d / ck['cache_pattern']))
        out.append(getattr(mod, cls_name)(fp, cache_kwargs=ck, **kw))
        if name == 'port':
            out.append(getattr(mod, cls_name)(fp, cache_kwargs=ck, **kw))
            for f in os.listdir(d):
                _assert_files_equal(str(d / f),
                                    str(tmp_path / 'cache_jax' / f))
    return out


@pytest.mark.parametrize('ext', ['h5', 'nc'])
def test_data_handler_cache_reload_matches_jax(tmp_path, ext):
    fp = make_fake_nc_file(str(tmp_path / 'wind.nc'), (7, 6, 10),
                           ['u100', 'v100'])
    jax, port, hit = _handlers_both(
        'DataHandler', fp, tmp_path, features=['u_100m', 'windspeed_100m'],
        cache_kwargs={'cache_pattern': 'c_{feature}.' + ext,
                      'max_workers': 2})
    assert port.rasterizer is not None and hit.rasterizer is None
    for dh in (port, hit):
        assert dh.features == ['u_100m', 'windspeed_100m']
        np.testing.assert_allclose(np.asarray(dh.data.data),
                                   np.asarray(jax.data.data),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(dh.time_index.values),
            np.asarray(jax.data.time_index.values))


def test_daily_handler_caching_matches_jax(tmp_path):
    fp = make_fake_h5_file(str(tmp_path / 'wtk.h5'), (12, 12, 72),
                           ['windspeed_100m', 'winddirection_100m'],
                           value_range=(0, 20))
    jax, port, hit = _handlers_both(
        'DataHandlerH5WindCC', fp, tmp_path,
        features=['u_100m', 'v_100m'], hr_spatial_coarsen=2,
        cache_kwargs={'cache_pattern': 'cc_{feature}.h5',
                      'max_workers': 1})
    assert hit.rasterizer is None
    assert hit.daily.data.shape == (6, 6, 3, 2)
    for dh in (port, hit):
        for member in ('hourly', 'daily'):
            got, want = getattr(dh, member), getattr(jax, member)
            np.testing.assert_allclose(got.data, np.asarray(want.data),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(
                np.asarray(got.time_index.values).astype('datetime64[ns]'),
                np.asarray(want.time_index.values).astype(
                    'datetime64[ns]'))


def test_solar_cc_trim_caching_matches_jax(tmp_path):
    """H5SolarCC caches its untrimmed hourly member, so the reload
    rederives the totals-based daily clearsky_ratio."""
    fp = make_fake_h5_file(
        str(tmp_path / 'nsrdb.h5'), (5, 5, 48), ['ghi', 'clearsky_ghi'],
        start='2023-06-01', freq='h', scale_factor=1.0,
        value_range=(0, 1000))
    jax, port, hit = _handlers_both(
        'DataHandlerH5SolarCC', fp, tmp_path, features=['clearsky_ratio'],
        cache_kwargs={'cache_pattern': 'solar_{feature}.h5'})
    assert os.path.exists(tmp_path / 'cache_port' / 'solar_ghi.h5')
    for dh in (port, hit):
        assert dh.daily.features == ['clearsky_ratio']
        np.testing.assert_allclose(
            dh.daily['clearsky_ratio'], np.asarray(
                jax.daily['clearsky_ratio']), rtol=1e-5, atol=1e-6,
            equal_nan=True)


def test_lazy_mode_still_refuses_cache(tmp_path):
    fp = make_fake_nc_file(str(tmp_path / 'wind.nc'), (7, 6, 10),
                           ['u100', 'v100'])
    with pytest.raises(NotImplementedError, match='cache_kwargs'):
        port_dh.DataHandler(fp, features=['u_100m'], mode='lazy',
                            cache_kwargs={'cache_pattern': str(
                                tmp_path / 'c_{feature}.h5')})
