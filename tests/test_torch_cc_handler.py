"""The port's climate-change feed against the JAX package's on the same
data and the same ``RANDOM_GENERATOR`` seed (the mirror of
tests/batch_handlers/test_cc_handler.py and the pipeline of
tests/training/test_train_solar.py):

- ``nsrdb_reduce_daily_data``: identical windows;
- ``DualSamplerCC``: solar at 8x (daylight window, NaN fill), 24x,
  spatial coarsening, wind features not reduced, LR = daily mean:
  identical samples (1e-6 of max for the coarsened LR);
- ``BatchHandlerCC``: identical batches and shapes, and stats from the
  hourly member, NaN-aware;
- ``DailyDataHandler`` / ``DataHandlerH5WindCC`` (daily max / min) and
  ``DataHandlerH5SolarCC`` (totals-based daily clearsky_ratio, helper
  channels trimmed) on an NSRDB-style H5 fixture and on a NetCDF3 file
  of ghi and clearsky_ghi: equal daily and hourly data (1e-6 of max) and
  time indexes; ``mode='lazy'`` refused;
- ``SolarCC`` trained one epoch over ``BatchHandlerCC`` of
  ``DataHandlerH5SolarCC`` data in both packages at
  ``weight_gen_advers=0`` (the content loss, which no window draw
  enters): losses within rtol 1e-4, from the same weights, Adam with
  epsilon 1 (tests/test_torch_train_step.py).
"""

import numpy as np
import pytest
import torch

import sup3r_tpu.preprocessing.batch_handlers as jax_bh
import sup3r_tpu.preprocessing.data_handlers as jax_dh
import sup3r_tpu.preprocessing.samplers as jax_samplers
from sup3r_tpu.models import SolarCC as JaxSolarCC
from sup3r_tpu.preprocessing.grid import GridDataset as JaxGrid
from sup3r_tpu.preprocessing.grid import PairedDataset as JaxPaired
from sup3r_tpu.utilities import RANDOM_GENERATOR as JAX_RNG
from sup3r_tpu.utilities.test_helpers import make_fake_h5_file
from sup3r_tpu_torch.models import SolarCC
from sup3r_tpu_torch.models.weights import params_from_jax, params_to_jax
from sup3r_tpu_torch.preprocessing import (
    BatchHandlerCC,
    DailyDataHandler,
    DataHandlerH5SolarCC,
    DataHandlerH5WindCC,
    DualSamplerCC,
    GridDataset,
    PairedDataset,
    StatsCollection,
    nsrdb_reduce_daily_data,
)
from sup3r_tpu_torch.utilities import RANDOM_GENERATOR, TimeIndex
from sup3r_tpu_torch.utilities.test_helpers import make_fake_nc_file

torch.set_num_threads(1)

RTOL = 1e-4
STEP_OPT = {'name': 'Adam', 'learning_rate': 1e-4, 'epsilon': 1.0}
PORT = {'sampler': DualSamplerCC, 'handler': BatchHandlerCC,
        'grid': GridDataset, 'paired': PairedDataset,
        'reduce': nsrdb_reduce_daily_data,
        'H5SolarCC': DataHandlerH5SolarCC, 'H5WindCC': DataHandlerH5WindCC,
        'Daily': DailyDataHandler}
JAX = {'sampler': jax_samplers.DualSamplerCC,
       'handler': jax_bh.BatchHandlerCC, 'grid': JaxGrid,
       'paired': JaxPaired, 'reduce': jax_samplers.nsrdb_reduce_daily_data,
       'H5SolarCC': jax_dh.DataHandlerH5SolarCC,
       'H5WindCC': jax_dh.DataHandlerH5WindCC,
       'Daily': jax_dh.DailyDataHandler}
PACKAGES = {'port': PORT, 'jax': JAX}


def _reseed(seed):
    for rng in (RANDOM_GENERATOR, JAX_RNG):
        rng.bit_generator.state = np.random.default_rng(
            seed).bit_generator.state


def _daily_hourly(package, s1=20, s2=20, n_days=5, solar=True):
    """test_cc_handler.py's (daily, hourly) pair, drawn from a seeded
    numpy generator, in the package's containers."""
    pkg = PACKAGES[package]
    t = n_days * 24
    ti = np.datetime64('2023-06-01T00', 'ns') + np.arange(t) * np.timedelta64(
        1, 'h')
    hours = (ti - ti.astype('datetime64[D]')) // np.timedelta64(1, 'h')
    data = np.random.default_rng(0).random((s1, s2, t, 2)).astype(
        np.float32)
    features = (['clearsky_ratio', 'u_100m'] if solar
                else ['u_100m', 'v_100m'])
    if solar:
        data[:, :, ~np.isin(hours, range(8, 16)), 0] = np.nan
    lat = np.linspace(40, 39, s1)
    lon = np.linspace(-105.5, -104.3, s2)
    lat_lon = np.dstack(np.meshgrid(lat, lon, indexing='ij'))
    days = ti.astype('datetime64[D]')
    daily = np.stack([np.nanmean(data[:, :, days == d], axis=2)
                      for d in np.unique(days)], axis=2)
    if package == 'jax':
        import pandas as pd

        ti, day_index = pd.DatetimeIndex(ti), pd.DatetimeIndex(
            np.unique(days))
    else:
        ti, day_index = TimeIndex(ti), TimeIndex(np.unique(days))
    return pkg['paired'](
        daily=pkg['grid'](daily, features, lat_lon=lat_lon,
                          time_index=day_index),
        hourly=pkg['grid'](data.copy(), features, lat_lon=lat_lon,
                           time_index=ti))


def _both(fn):
    """fn(package) for both packages from the same seed."""
    out = {}
    for package in ('port', 'jax'):
        _reseed(11)
        out[package] = fn(package)
    return out['port'], out['jax']


def _equal(got, want, rtol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if rtol:
        np.testing.assert_allclose(got, want, rtol=0, equal_nan=True,
                                   atol=rtol * np.nanmax(np.abs(want)))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('case', ['centred', 'late', 'all_night',
                                  'long_shape'])
def test_nsrdb_reduce_daily_data(case):
    data = np.random.default_rng(2).random((1, 4, 4, 24, 1)).astype(
        np.float32)
    shape = 8
    if case == 'centred':
        data[..., :8, 0] = np.nan
        data[..., 16:, 0] = np.nan
    elif case == 'late':
        data[..., :17, 0] = np.nan
    elif case == 'all_night':
        data[..., 0] = np.nan
    else:
        shape = 30
    got = nsrdb_reduce_daily_data(data, shape, csr_ind=0)
    want = jax_samplers.nsrdb_reduce_daily_data(data, shape, csr_ind=0)
    _equal(got, want)
    if case == 'centred':
        assert got.shape == (1, 4, 4, 8, 1)
        assert not np.isnan(got).any()


#: sampler cases: (solar data, HR sample shape, s_enhance, t_enhance)
SAMPLER_CASES = {
    'solar_8x': (True, (8, 8, 8), 1, 8),
    'solar_24x': (True, (8, 8, 24), 1, 24),
    'wind_24x': (False, (8, 8, 48), 1, 24),
    'coarsened': (False, (8, 8, 24), 2, 24),
    'solar_coarsened_8x': (True, (8, 8, 16), 2, 8),
}


@pytest.mark.parametrize('case', list(SAMPLER_CASES))
def test_dual_sampler_cc_matches_jax(case):
    solar, shape, s_enh, t_enh = SAMPLER_CASES[case]

    def draws(package):
        sampler = PACKAGES[package]['sampler'](
            _daily_hourly(package, solar=solar), sample_shape=shape,
            s_enhance=s_enh, t_enhance=t_enh)
        return [next(sampler) for _ in range(4)], sampler

    (port, sampler), (jax, jsampler) = _both(draws)
    assert sampler.t_enhance == jsampler.t_enhance == t_enh
    assert sampler.hr_features == jsampler.hr_features
    for (lr, hr), (jlr, jhr) in zip(port, jax):
        _equal(lr, jlr, rtol=1e-6 if s_enh > 1 else 0.0)
        _equal(hr, jhr)
        assert lr.shape == (8 // s_enh, 8 // s_enh, shape[2] // t_enh, 2)
        assert hr.shape == (8, 8, shape[2], 2)
        assert not np.isnan(hr).any()


def test_dual_sampler_cc_lr_matches_daily_mean():
    """Non-solar 24x: the LR sample is the day-mean of the HR sample."""
    sampler = DualSamplerCC(_daily_hourly('port', solar=False),
                            sample_shape=(8, 8, 48), s_enhance=1,
                            t_enhance=24)
    for _ in range(4):
        lr, hr = next(sampler)
        np.testing.assert_allclose(
            lr, hr.reshape(8, 8, 2, 24, 2).mean(axis=3), atol=1e-5)


def test_dual_sampler_cc_wind_features_not_reduced():
    """Only the csr channel drives the daylight window: the window is
    the finite-csr hours 8-16 and the wind channel keeps its hourly
    values there."""
    paired = _daily_hourly('port', solar=True)
    hourly = paired['hourly'].data.copy()
    sampler = DualSamplerCC(paired, sample_shape=(8, 8, 8), s_enhance=1,
                            t_enhance=8)
    _reseed(3)
    lr_idx, hr_idx = sampler.get_sample_index()
    _reseed(3)
    _, hr = next(sampler)
    day0 = hr_idx[2].start
    np.testing.assert_array_equal(
        hr[..., 1], hourly[hr_idx[0], hr_idx[1], day0 + 8:day0 + 16, 1])
    assert not np.isnan(hr).any()


def test_dual_sampler_cc_needs_daily_and_hourly():
    paired = _daily_hourly('port')
    with pytest.raises(ValueError, match='daily and hourly'):
        DualSamplerCC(PairedDataset(low_res=paired['daily'],
                                    high_res=paired['hourly']))
    with pytest.raises(ValueError, match='multiple of t_enhance'):
        DualSamplerCC(paired, sample_shape=(8, 8, 12), t_enhance=8)


@pytest.mark.parametrize('solar, t_enhance, shape', [
    (True, 8, (8, 8, 8)), (False, 24, (8, 8, 24))])
def test_batch_handler_cc_matches_jax(solar, t_enhance, shape):
    def batches(package):
        handler = PACKAGES[package]['handler'](
            [_daily_hourly(package, solar=solar)], batch_size=2,
            n_batches=3, s_enhance=1, t_enhance=t_enhance,
            sample_shape=shape)
        try:
            out = [tuple(np.asarray(m) for m in b) for b in handler]
        finally:
            handler.stop()
        return out, handler

    (port, handler), (jax, jhandler) = _both(batches)
    assert handler.lr_shape == jhandler.lr_shape
    assert handler.hr_shape == jhandler.hr_shape
    assert handler.means == pytest.approx(jhandler.means, rel=1e-5)
    assert handler.stds == pytest.approx(jhandler.stds, rel=1e-5)
    assert len(port) == 3
    for (lr, hr), (jlr, jhr) in zip(port, jax):
        _equal(lr, jlr, rtol=1e-6)
        _equal(hr, jhr, rtol=1e-6)
        assert lr.shape == (2, 8, 8, shape[2] // t_enhance, 2)
        assert hr.shape == (2, *shape, 2)
        assert not np.isnan(hr).any()


def test_cc_stats_use_hourly_member_nan_aware():
    paired = _daily_hourly('port')
    csr = np.asarray(paired['hourly']['clearsky_ratio'])
    mean, std = float(np.nanmean(csr)), float(np.nanstd(csr))
    stats = StatsCollection([paired])
    assert np.isclose(stats.means['clearsky_ratio'], mean, rtol=1e-5)
    assert np.isclose(stats.stds['clearsky_ratio'], std, rtol=1e-5)


def _nsrdb_h5(tmp_path, features=('ghi', 'clearsky_ghi'), shape=(8, 9, 72),
              start='2023-06-01'):
    _reseed(5)
    return make_fake_h5_file(str(tmp_path / 'nsrdb.h5'), shape,
                             list(features), start=start, freq='h',
                             scale_factor=1.0, value_range=(1, 1000))


def _nsrdb_nc(tmp_path, shape=(8, 9, 72)):
    """A NetCDF3 file of ghi and clearsky_ghi (clearsky above ghi), as
    the card's machine reads it without h5py."""
    rng = np.random.default_rng(5)
    s1, s2, t = shape
    cs = 2 + 998 * rng.random((t, s1, s2))
    ghi = cs * rng.random((t, s1, s2))
    return make_fake_nc_file(str(tmp_path / 'nsrdb.nc'), shape,
                             ['ghi', 'clearsky_ghi'], start='2023-06-01',
                             data={'ghi': ghi, 'clearsky_ghi': cs})


def _compare_handlers(port, jax):
    for member in ('daily', 'hourly'):
        got, want = getattr(port, member), getattr(jax, member)
        assert got.features == want.features
        _equal(got.data, want.data, rtol=1e-6)
        np.testing.assert_array_equal(
            np.asarray(got.time_index).astype('datetime64[ns]'),
            np.asarray(want.time_index).astype('datetime64[ns]'))
    assert port.shape == jax.shape


@pytest.mark.parametrize('source', ['h5', 'nc'])
@pytest.mark.parametrize('features', [
    ['clearsky_ratio'], ['clearsky_ratio', 'ghi', 'clearsky_ghi']])
def test_data_handler_h5_solar_cc_matches_jax(tmp_path, source, features):
    """The daily clearsky_ratio is total ghi / total clearsky ghi; the
    helper channels are trimmed unless requested. The NetCDF3 file is
    what the card's loop feeds the handler."""
    fp = _nsrdb_h5(tmp_path) if source == 'h5' else _nsrdb_nc(tmp_path)
    port = DataHandlerH5SolarCC(fp, features=list(features))
    jax = jax_dh.DataHandlerH5SolarCC(fp, features=list(features))
    _compare_handlers(port, jax)
    assert port.daily.shape == (8, 9, 3, len(features))
    assert port.hourly.features == features
    assert len(port.time_index) == 72


def test_daily_data_handler_trims_partial_days(tmp_path):
    """A time range that starts at noon: the partial first and last days
    are dropped before the daily means."""
    fp = _nsrdb_h5(tmp_path, shape=(4, 5, 60), start='2023-06-01 12:00')
    port = DailyDataHandler(fp, features=['ghi'])
    jax = jax_dh.DailyDataHandler(fp, features=['ghi'])
    _compare_handlers(port, jax)
    assert port.daily.shape[2] == 2 and port.hourly.shape[2] == 48


def test_data_handler_h5_wind_cc_daily_extremes(tmp_path):
    fp = _nsrdb_h5(tmp_path, features=('temperature_2m',
                                       'relativehumidity_2m', 'u_100m'))
    feats = ['temperature_max_2m', 'temperature_min_2m',
             'relativehumidity_max_2m', 'relativehumidity_min_2m', 'u_100m']
    port = DataHandlerH5WindCC(fp, features=feats)
    jax = jax_dh.DataHandlerH5WindCC(fp, features=feats)
    _compare_handlers(port, jax)
    hourly = port.hourly['temperature_max_2m']
    np.testing.assert_array_equal(port.daily['temperature_max_2m'][..., 0],
                                  hourly[..., :24].max(axis=2))
    np.testing.assert_array_equal(port.daily['temperature_min_2m'][..., 0],
                                  hourly[..., :24].min(axis=2))


@pytest.mark.parametrize('source', ['h5', 'nc'])
def test_daily_handlers_refuse_lazy_mode(tmp_path, source):
    """``mode='lazy'`` daily handlers give the eager daily and hourly
    members (bit-exact windows, the NetCDF3 file the card reads too) and
    the JAX package's; what they cannot window, a full-domain remap, is
    still refused in both packages."""
    fp = _nsrdb_h5(tmp_path) if source == 'h5' else _nsrdb_nc(tmp_path)
    feats = ['clearsky_ratio', 'ghi', 'clearsky_ghi']
    lazy = DataHandlerH5SolarCC(fp, features=feats, mode='lazy')
    eager = DataHandlerH5SolarCC(fp, features=feats)
    jax = jax_dh.DataHandlerH5SolarCC(fp, features=feats, mode='lazy')
    for member in ('daily', 'hourly'):
        got = getattr(lazy, member)
        idx = (slice(None), slice(None), slice(None), feats)
        np.testing.assert_array_equal(got.sample(idx),
                                      getattr(eager, member).sample(idx))
        np.testing.assert_array_equal(got.sample(idx),
                                      getattr(jax, member).sample(idx))
    for cls in (DataHandlerH5SolarCC, jax_dh.DataHandlerH5SolarCC):
        with pytest.raises(NotImplementedError, match='time_roll'):
            cls(fp, features=feats, mode='lazy', time_roll=1)


def _solar_cc_train(package, fp, weights):
    gen = [{'class': 'Conv3D', 'filters': 8, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'},
           {'class': 'SpatioTemporalExpansion', 'temporal_mult': 8,
            'temporal_method': 'depth_to_time', 't_roll': 4},
           {'class': 'LeakyReLU', 'alpha': 0.2},
           {'class': 'Conv3D', 'filters': 1, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'}]
    disc = [{'class': 'Conv3D', 'filters': 4, 'kernel_size': 3,
             'strides': 2, 'padding': 'same'},
            {'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    pkg = PACKAGES[package]
    handler = pkg['H5SolarCC'](fp, features=['clearsky_ratio', 'ghi',
                                             'clearsky_ghi'])
    batcher = pkg['handler'](
        [handler], batch_size=2, n_batches=3, s_enhance=1, t_enhance=8,
        sample_shape=(6, 6, 24),
        feature_sets={'lr_only_features': ['clearsky_ghi', 'ghi']})
    kw = {'device': 'cpu'} if package == 'port' else {}
    model = (SolarCC if package == 'port' else JaxSolarCC)(
        gen, disc, optimizer=STEP_OPT, loss='MeanAbsoluteError', **kw)
    model.init_weights((1, *batcher.lr_shape), (1, *batcher.hr_shape))
    if package == 'port':
        params_from_jax(model._gen, weights)
    else:
        import jax

        model.gen_params = jax.tree.map(jax.numpy.asarray, weights)
        model._gen_opt_state = model._gen_tx.init(model.gen_params)
    try:
        model.train(batcher, input_resolution={'spatial': '4km',
                                               'temporal': '1440min'},
                    n_epoch=1, weight_gen_advers=0.0, train_gen=True,
                    train_disc=False, out_dir=None)
    finally:
        batcher.stop()
    return model, batcher


def test_solar_cc_trains_over_batch_handler_cc_like_jax(tmp_path):
    """tests/training/test_train_solar.py's pipeline: ghi / clearsky_ghi
    feed the generator as LR-only features; one epoch of 3 batches."""
    fp = _nsrdb_h5(tmp_path, shape=(12, 12, 72))
    seed_model = SolarCC([{'class': 'Conv3D', 'filters': 8,
                           'kernel_size': 3, 'strides': 1,
                           'padding': 'same'},
                          {'class': 'SpatioTemporalExpansion',
                           'temporal_mult': 8,
                           'temporal_method': 'depth_to_time', 't_roll': 4},
                          {'class': 'LeakyReLU', 'alpha': 0.2},
                          {'class': 'Conv3D', 'filters': 1,
                           'kernel_size': 3, 'strides': 1,
                           'padding': 'same'}],
                         [{'class': 'Flatten'},
                          {'class': 'Dense', 'units': 1}], device='cpu')
    seed_model.init_weights((1, 6, 6, 3, 3), (1, 6, 6, 24, 1), seed=0)
    weights = params_to_jax(seed_model._gen)
    (port, batcher), (jax, _) = _both(
        lambda package: _solar_cc_train(package, fp, weights))
    assert batcher.lr_shape == (6, 6, 3, 3)
    assert batcher.hr_shape == (6, 6, 24, 1)
    assert port.meta['class'] == 'SolarCC'
    assert port.lr_features == ['clearsky_ratio', 'ghi', 'clearsky_ghi']
    assert port.hr_out_features == ['clearsky_ratio']
    for key in ('train_loss_gen', 'train_loss_gen_content'):
        np.testing.assert_allclose(port.history[key],
                                   jax.history[key].values, rtol=RTOL,
                                   err_msg=key)
