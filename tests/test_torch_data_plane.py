"""The port's data plane against the JAX package's on the same files:
the pandas-free time index against pandas, the NetCDF / H5 loaders and
``DataHandler`` (arrays, lat/lon, time index), the fake-file helper, and
the writers (synthesized times and coordinates, NetCDF and H5 files).
Float arrays agree exactly: both sides run the same numpy code."""

import h5py
import numpy as np
import pandas as pd
import pytest
from scipy.io import netcdf_file

from sup3r_tpu.postprocessing.writers import OutputHandlerH5 as JaxH5
from sup3r_tpu.postprocessing.writers import OutputHandlerNC as JaxNC
from sup3r_tpu.preprocessing.data_handlers import DataHandler as JaxDH
from sup3r_tpu.preprocessing.loaders import LoaderH5 as JaxLoaderH5
from sup3r_tpu.preprocessing.loaders import LoaderNC as JaxLoaderNC
from sup3r_tpu.preprocessing.loaders import decode_cf_time as jax_decode
from sup3r_tpu.utilities import test_helpers as jax_helpers
from sup3r_tpu.utilities.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu_torch.postprocessing.writers import (
    OutputHandlerH5,
    OutputHandlerNC,
)
from sup3r_tpu_torch.preprocessing import DataHandler, LoaderH5, LoaderNC
from sup3r_tpu_torch.preprocessing.loaders import decode_cf_time
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, TimeIndex
from sup3r_tpu_torch.utilities.test_helpers import make_fake_nc_file
from sup3r_tpu_torch.utilities.times import date_range, format_timestamps

FEATURES = ['u_100m', 'v_100m']


def _same_times(port, ref):
    np.testing.assert_array_equal(np.asarray(port.values),
                                  np.asarray(pd.DatetimeIndex(ref).values))


@pytest.mark.parametrize('start,freq,n', [
    ('2023-01-01', '1h', 30), ('2019-12-31 22:00', '37min', 80),
    ('2020-02-27', '6h', 20), ('1999-06-30 23:59:59', '1s', 5),
    ('2023-01-01', '150s', 9)])
def test_time_index_matches_pandas(start, freq, n):
    ref = pd.date_range(start, periods=n, freq=freq)
    got = TimeIndex(ref)
    for attr in ('month', 'day', 'hour', 'minute', 'second',
                 'dayofyear'):
        np.testing.assert_array_equal(getattr(got, attr),
                                      np.asarray(getattr(ref, attr)))
    # the H5 writer's time_index strings: pandas' str(), no 'T'
    assert format_timestamps(got) == [str(ts) for ts in ref]
    _same_times(got.shift(7, freq='min'), ref.shift(7, freq='min'))
    step = (ref[1] - ref[0]).to_numpy()
    _same_times(date_range(got[0], got[-1], step),
                pd.date_range(ref[0], ref[-1], freq=ref[1] - ref[0]))
    assert got[2:5].equals(TimeIndex(ref[2:5]))
    assert not got[2:5].equals(TimeIndex(ref[3:6]))


def test_fractional_seconds_format_like_pandas():
    stamps = ['2020-01-01 00:00:00.5', '2020-01-01 00:00:00.000000001',
              '2020-01-01 12:30:00']
    assert format_timestamps(stamps) == [str(pd.Timestamp(s))
                                         for s in stamps]


@pytest.mark.parametrize('units,calendar,values', [
    ('hours since 1900-01-01', 'standard', [0, 1, 1078248.0, 1078249.5]),
    ('days since 2000-01-01 06:00:00', 'gregorian', [0, 0.25, 366.5]),
    ('minutes since 2015-07-01T00:00:00Z', 'standard', [-30, 0, 45]),
    ('seconds since 2010-03-01 00:00:00+02:00', 'standard', [0, 3600]),
    ('days since 2020-02-28', 'noleap', [0, 1, 2, 365, 400.5]),
    ('hours since 2001-01-01', '360_day', [0, 24 * 59, 24 * 360 + 7]),
])
def test_decode_cf_time_matches(units, calendar, values):
    _same_times(decode_cf_time(values, units, calendar),
                jax_decode(values, units, calendar))


def test_fake_nc_file_matches_jax_helper(tmp_path):
    """The port's helper writes the same file as the JAX package's when
    both generators start from the same state."""
    state = np.random.default_rng(3).bit_generator.state
    JAX_RNG.bit_generator.state = state
    RANDOM_GENERATOR.bit_generator.state = state
    a = jax_helpers.make_fake_nc_file(str(tmp_path / 'a.nc'), (5, 6, 7),
                                      FEATURES)
    b = make_fake_nc_file(str(tmp_path / 'b.nc'), (5, 6, 7), FEATURES)
    with netcdf_file(a, 'r', mmap=False) as fa, \
            netcdf_file(b, 'r', mmap=False) as fb:
        assert set(fa.variables) == set(fb.variables)
        for name in fa.variables:
            np.testing.assert_array_equal(fa.variables[name].data,
                                          fb.variables[name].data)


def _nc_file(tmp_path, **kwargs):
    return jax_helpers.make_fake_nc_file(
        str(tmp_path / 'in.nc'), (9, 7, 10),
        ['u_100m', 'v_100m', 'temperature'], **kwargs)


@pytest.mark.parametrize('kwargs', [{}, {'ascending_lats': True},
                                    {'levels': [1000.0, 850.0, 925.0]}])
def test_loader_nc_matches(tmp_path, kwargs):
    path = _nc_file(tmp_path, **kwargs)
    got, want = LoaderNC(path).data, JaxLoaderNC(path).data
    assert got.features == want.features
    np.testing.assert_array_equal(got.lat_lon, want.lat_lon)
    _same_times(got.time_index, want.time_index)
    np.testing.assert_array_equal(got.levels, want.levels)
    for name in want.features:
        assert got.dims(name) == want.dims(name)
        np.testing.assert_array_equal(got[name], want[name])


def test_loader_h5_matches(tmp_path):
    path = jax_helpers.make_fake_h5_file(
        str(tmp_path / 'in.h5'), (6, 5, 12),
        ['windspeed_100m', 'winddirection_100m'])
    got, want = LoaderH5(path), JaxLoaderH5(path)
    assert got.features == want.features
    np.testing.assert_array_equal(got.lat_lon_flat, want.lat_lon_flat)
    np.testing.assert_array_equal(got.elevation, want.elevation)
    _same_times(got.time_index, want.time_index)
    for f in want.features:
        np.testing.assert_array_equal(
            got.get(f, slice(2, 9), [0, 4, 7, 29]),
            want.get(f, slice(2, 9), [0, 4, 7, 29]))


@pytest.mark.parametrize('source,kwargs', [
    ('nc', {}),
    ('nc', {'time_slice': slice(2, 8), 'hr_spatial_coarsen': 2}),
    ('nc', {'target': (39.5, -105.2), 'shape': (4, 3),
            'time_shift': 30}),
    ('h5', {}),
    ('h5', {'time_slice': slice(1, 9, 2)}),
])
def test_data_handler_matches(tmp_path, source, kwargs):
    """Loader -> Rasterizer -> Deriver: u/v from the NetCDF file as is,
    or derived from the H5 file's windspeed/winddirection."""
    if source == 'nc':
        path = _nc_file(tmp_path)
    else:
        path = jax_helpers.make_fake_h5_file(
            str(tmp_path / 'in.h5'), (8, 8, 10),
            ['windspeed_100m', 'winddirection_100m'])
    got = DataHandler(path, features=FEATURES, **kwargs)
    want = JaxDH(path, features=FEATURES, **kwargs)
    assert got.features == want.features
    np.testing.assert_array_equal(got.lat_lon, want.lat_lon)
    _same_times(got.time_index, want.time_index)
    np.testing.assert_array_equal(got.data.as_array(FEATURES),
                                  want.data.as_array(FEATURES))


@pytest.mark.parametrize('start,freq,n,shape', [
    ('2023-01-01', '1h', 8, 32), ('2020-02-28', '1D', 3, 72),
    ('2021-02-28', '1D', 3, 72), ('2023-05-01', '2h', 1, 3)])
def test_get_times_matches(start, freq, n, shape):
    """High-res time synthesis, with the leap-day drop."""
    lr = pd.date_range(start, periods=n, freq=freq)
    _same_times(OutputHandlerNC.get_times(TimeIndex(lr), shape),
                JaxNC.get_times(lr, shape))


@pytest.mark.parametrize('freq,n', [('h', 4), ('D', 2), ('h', 30)])
@pytest.mark.parametrize('built_by', ['date_range', 'decode_cf_time'])
def test_get_times_t_enhance_7_matches(freq, n, built_by):
    """t_enhance 7 does not divide an hourly or daily step in
    nanoseconds: the port floors the HR step to the input index's
    resolution (microseconds here, as pandas holds both indexes), so
    every timestamp equals the JAX package's."""
    step = np.timedelta64(1, freq)
    if built_by == 'date_range':
        port_lr = date_range('2023-01-01',
                             np.datetime64('2023-01-01') + (n - 1) * step,
                             step)
        jax_lr = pd.date_range('2023-01-01', periods=n, freq=freq)
    else:
        units = ('hours' if freq == 'h' else 'days') + ' since 2023-01-01'
        port_lr = decode_cf_time(np.arange(n, dtype=float), units)
        jax_lr = jax_decode(np.arange(n, dtype=float), units)
    assert port_lr.unit == jax_lr.unit == 'us'
    got = OutputHandlerNC.get_times(port_lr, 7 * n)
    _same_times(got, JaxNC.get_times(jax_lr, 7 * n))
    assert got.unit == 'us'


def _chunk_output(s1=6, s2=5, t=8):
    rng = np.random.default_rng(5)
    data = rng.normal(0, 6, (s1, s2, t, 2)).astype(np.float32)
    lr_ll = np.dstack(np.meshgrid(np.linspace(40, 39, 3),
                                  np.linspace(-105.5, -104.3, 3),
                                  indexing='ij'))
    lat_lon = OutputHandlerNC.get_lat_lon(lr_ll, (s1, s2))
    np.testing.assert_array_equal(lat_lon, JaxNC.get_lat_lon(lr_ll,
                                                             (s1, s2)))
    times = pd.date_range('2023-01-01', periods=t, freq='15min')
    return data, lat_lon, times


def test_nc_writer_matches(tmp_path):
    data, lat_lon, times = _chunk_output()
    meta = {'note': 'same'}
    OutputHandlerNC._write_output(data.copy(), FEATURES, lat_lon,
                                  TimeIndex(times), str(tmp_path / 'p.nc'),
                                  meta_data=meta)
    JaxNC._write_output(data.copy(), FEATURES, lat_lon, times,
                        str(tmp_path / 'j.nc'), meta_data=meta)
    with netcdf_file(str(tmp_path / 'p.nc'), 'r', mmap=False) as fp, \
            netcdf_file(str(tmp_path / 'j.nc'), 'r', mmap=False) as fj:
        assert set(fp.variables) == set(fj.variables)
        for name in fj.variables:
            np.testing.assert_array_equal(fp.variables[name].data,
                                          fj.variables[name].data)
        assert fp.gan_meta == fj.gan_meta


@pytest.mark.parametrize('invert_uv', [True, False])
def test_h5_writer_matches(tmp_path, invert_uv):
    data, lat_lon, times = _chunk_output()
    gids = np.arange(30).reshape(6, 5) + 100
    OutputHandlerH5._write_output(data.copy(), FEATURES, lat_lon,
                                  TimeIndex(times), str(tmp_path / 'p.h5'),
                                  gids=gids, invert_uv=invert_uv)
    JaxH5._write_output(data.copy(), FEATURES, lat_lon, times,
                        str(tmp_path / 'j.h5'), gids=gids,
                        invert_uv=invert_uv)
    with h5py.File(tmp_path / 'p.h5') as fp, h5py.File(tmp_path / 'j.h5') \
            as fj:
        assert set(fp) == set(fj)
        for name in fj:
            np.testing.assert_array_equal(fp[name][:], fj[name][:])
            np.testing.assert_equal(dict(fp[name].attrs),
                                    dict(fj[name].attrs))
