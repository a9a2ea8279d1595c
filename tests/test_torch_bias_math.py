"""The bias slice's math against the JAX package on the same numpy
inputs: ``bias/qdm_math.py`` (the host transform within rtol 1e-6, the
torch device transform against the JAX package's jitted one and the
host one at rtol 2e-4 / atol 2e-2 with equal NaN masks), the time-index
kwargs of ``bias/transforms.py`` without pandas, the runtime transforms
(rtol 1e-6) on H5 factor files from the fixtures of tests/bias/, and the
same factor file read as H5 and as NetCDF3."""

import json

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

import sup3r_tpu.bias.transforms as jax_tf
from sup3r_tpu.bias import qdm_math as jax_math
from sup3r_tpu_torch.bias import qdm_math
from sup3r_tpu_torch.bias import transforms as tf
from sup3r_tpu_torch.utilities.test_helpers import write_nc_factor_file
from sup3r_tpu_torch.utilities.times import TimeIndex
from tests.bias.test_fwp_qdm_presrat import _qdm_file
from tests.bias.test_transform_coverage import _factor_file

torch.set_num_threads(1)

RTOL = 1e-6
DEV_RTOL, DEV_ATOL = 2e-4, 2e-2


def _cdf_rows(rng, n_cols, nq, loc=10.0, scale=2.0):
    q = qdm_math.sampled_quantiles(nq) * 100
    return np.stack([np.percentile(rng.normal(loc, scale, 500), q)
                     for _ in range(n_cols)]).astype(np.float32)


@pytest.mark.parametrize('sampling', ['linear', 'log', 'invlog'])
def test_sampled_quantiles_match_jax(sampling):
    np.testing.assert_array_equal(
        qdm_math.sampled_quantiles(21, sampling, 7),
        jax_math.sampled_quantiles(21, sampling, 7))
    with pytest.raises(KeyError):
        qdm_math.sampled_quantiles(5, 'nope')


@pytest.mark.parametrize('kwargs', [
    dict(relative=False),
    dict(relative=True),
    dict(relative=True, delta_denom_min=9.0, delta_range=(0.5, 1.5)),
    dict(relative=False, delta_range=(-1.0, 1.0), sampling='invlog'),
    dict(relative=True, delta_denom_zero=1.0, params_mf=None),
], ids=['absolute', 'relative', 'denom_min_range', 'abs_range_invlog',
        'denom_zero_no_trend'])
def test_host_qdm_matches_jax(kwargs):
    rng = np.random.default_rng(1)
    oh, mh, mf = (_cdf_rows(rng, 6, 31, loc) for loc in (10, 12, 13))
    mh[2, :5] = 0.0
    kwargs = dict(kwargs)
    no_trend = 'params_mf' in kwargs and kwargs.pop('params_mf') is None
    mf = None if no_trend else mf
    data = rng.normal(12, 3, (40, 6))
    got = qdm_math.QuantileDeltaMapping(oh, mh, mf, **kwargs)(data)
    want = jax_math.QuantileDeltaMapping(oh, mh, mf, **kwargs)(data)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize('relative', [True, False])
def test_device_qdm_matches_jax_and_host(relative):
    """The torch transform (run on the CPU) against the JAX
    package's jitted one and the float64 host transform; NaN parameter
    rows (invalid gids) give NaN columns in all three."""
    import jax

    rng = np.random.default_rng(2)
    oh, mh, mf = (_cdf_rows(rng, 8, 21, loc) for loc in (10, 12, 13))
    for p in (oh, mh, mf):
        p[3] = np.nan
    data = rng.normal(12, 3, (8, 50)).astype(np.float32)
    q = qdm_math.sampled_quantiles(21).astype(np.float32)
    kw = dict(relative=relative, delta_denom_min=1e-3 if relative else None)
    got = qdm_math.qdm_transform_device(
        torch.as_tensor(data), oh, mh, mf, q, **kw)
    assert got.dtype == torch.float32 and got.shape == data.shape
    got = got.numpy()
    want = np.asarray(jax.jit(lambda d, a, b, c: jax_math.qdm_transform_device(
        d, a, b, c, q, **kw))(data, oh, mh, mf))
    host = qdm_math.QuantileDeltaMapping(oh, mh, mf, **kw)(data.T).T
    for ref in (want, host):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got, ref, rtol=DEV_RTOL, atol=DEV_ATOL,
                                   equal_nan=True)
    assert np.isnan(got[3]).all() and np.isfinite(np.delete(got, 3, 0)).all()


def _noleap_2016():
    full = pd.date_range('2016-01-01', '2016-12-31', freq='D')
    return full[~((full.month == 2) & (full.day == 29))]


@pytest.mark.parametrize('index', [
    pd.date_range('2016-02-27', periods=72, freq='h'),
    pd.date_range('2015-12-20', periods=40, freq='D'),
    pd.date_range('2020-06-01 00:30', periods=11, freq='30min'),
    pd.date_range('2021-03-03', periods=1, freq='D'),
    _noleap_2016(),
], ids=['hourly', 'daily', '30min', 'single', 'noleap_drop_leap'])
def test_date_range_kwargs_match_jax(index):
    """The port builds pandas' kwargs without pandas and rebuilds the
    same stamps from them (and from the JAX package's kwargs)."""
    got = tf.get_date_range_kwargs(TimeIndex(index.values))
    want = jax_tf.get_date_range_kwargs(index)
    assert got == want
    if len(index) > 1:
        assert tf.make_time_index_from_kws(got).equals(index.values)
    assert tf.make_time_index_from_kws(want).equals(
        jax_tf.make_time_index_from_kws(want).values)


def test_date_range_kwargs_refuse_gaps():
    hourly = pd.date_range('2015-01-01', '2015-12-31 23:00', freq='h')
    gap = hourly[~((hourly.month == 6) & (hourly.day == 15))]
    with pytest.raises(ValueError, match='consistent frequency'):
        tf.get_date_range_kwargs(TimeIndex(gap.values))
    for freq in ('D', '1D', '24h', 'H', '60min', 'T'):
        kws = {'start': '2020-01-01 00:00:00', 'end': '2020-01-03 00:00:00',
               'freq': freq}
        assert tf.make_time_index_from_kws(kws).equals(
            pd.date_range(**{**kws, 'freq': freq.replace(
                'H', 'h').replace('T', 'min')}).values)
    with pytest.raises(ValueError, match='fixed step'):
        tf.make_time_index_from_kws({'start': '2020-01-01',
                                     'end': '2020-05-01', 'freq': 'MS'})


def test_window_mask_matches_jax():
    doy = np.arange(1, 367)
    for d0 in (1, 60, 182.5, 365, 7.6):
        for size in (3, 4, 15.2, 60):
            np.testing.assert_array_equal(
                tf.window_mask(doy, d0, size),
                jax_tf.window_mask(doy, d0, size))


def _grid(s, lat=(40.0, 39.0), lon=(-105.5, -104.3)):
    return np.dstack(np.meshgrid(np.linspace(*lat, s), np.linspace(*lon, s),
                                 indexing='ij'))


def _linear_file(path, s=6, nt=1, seed=3):
    rng = np.random.default_rng(seed)
    ll = _grid(s)
    with h5py.File(path, 'w') as f:
        f.create_dataset('latitude', data=ll[..., 0])
        f.create_dataset('longitude', data=ll[..., 1])
        f.create_dataset('u_100m_scalar', data=rng.uniform(
            0.5, 1.5, (s, s, nt)).astype(np.float32))
        f.create_dataset('u_100m_adder', data=rng.normal(
            0, 1, (s, s, nt)).astype(np.float32))
    return str(path)


def test_linear_transforms_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    data = rng.random((4, 4, 30)).astype(np.float32)
    ll = _grid(6)[1:5, 1:5]
    annual = _linear_file(tmp_path / 'lin.h5')
    monthly = _linear_file(tmp_path / 'mon.h5', nt=12)
    np.testing.assert_allclose(
        tf.global_linear_bc(data, 1.5, -0.2, out_range=(0, 1)),
        jax_tf.global_linear_bc(data, 1.5, -0.2, out_range=(0, 1)))
    for kw in ({}, {'smoothing': 0.8, 'out_range': (0, 1.2)}):
        np.testing.assert_allclose(
            tf.local_linear_bc(data, ll, 'u_100m', annual, **kw),
            jax_tf.local_linear_bc(data, ll, 'u_100m', annual, **kw),
            rtol=RTOL)
    dr = {'start': '2019-11-16 00:00:00', 'end': '2019-12-15 00:00:00',
          'freq': 'D'}
    for kw in ({}, {'temporal_avg': False, 'scalar_range': (0.8, 1.2),
                    'adder_range': (-0.5, 0.5)}):
        with pytest.warns(UserWarning) if not kw else _no_warn():
            got = tf.monthly_local_linear_bc(data, ll, 'u_100m', monthly,
                                             dr, **kw)
        with pytest.warns(UserWarning) if not kw else _no_warn():
            want = jax_tf.monthly_local_linear_bc(data, ll, 'u_100m',
                                                  monthly, dr, **kw)
        np.testing.assert_allclose(got, want, rtol=RTOL)


class _no_warn:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize('n_windows', [2, 5, 24])
def test_qdm_transform_nearest_window_matches_jax(tmp_path, n_windows):
    """Every stamp takes its nearest window center by day of year, as in
    the JAX package (the strict window would leave days uncovered)."""
    fp = _factor_file(tmp_path / 'bc.h5', n_windows)
    ti = pd.date_range('2015-01-01', '2015-12-31', freq='D')
    rng = np.random.default_rng(n_windows)
    data = rng.normal(12, 2, (4, 4, len(ti))).astype(np.float32)
    kws = jax_tf.get_date_range_kwargs(ti)
    for rel in (True, False):
        got = tf.local_qdm_bc(data, _grid(4), 'ws', 'u_100m', fp, kws,
                              relative=rel)
        want = jax_tf.local_qdm_bc(data, _grid(4), 'ws', 'u_100m', fp, kws,
                                   relative=rel)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize('no_trend', [False, True])
def test_presrat_transform_matches_jax(tmp_path, no_trend):
    fp = _factor_file(tmp_path / 'bc.h5', 5, with_presrat=True, k=1.3,
                      tau=9.5)
    ti = pd.date_range('2015-03-01', periods=90, freq='D')
    data = np.random.default_rng(5).normal(12, 2, (4, 4, 90)).astype(
        np.float32)
    kws = jax_tf.get_date_range_kwargs(ti)
    got = tf.local_presrat_bc(data, _grid(4), 'ws', 'u_100m', fp, kws,
                              relative=False, no_trend=no_trend,
                              k_range=(0.5, 1.2))
    want = jax_tf.local_presrat_bc(data, _grid(4), 'ws', 'u_100m', fp,
                                   kws, relative=False, no_trend=no_trend,
                                   k_range=(0.5, 1.2))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert (got == 0).any() != no_trend


def test_nonfinite_qdm_output_raises(tmp_path):
    fp = _factor_file(tmp_path / 'bc.h5', 2, mh_zero=True)
    ti = pd.date_range('2015-01-01', '2015-03-01', freq='D')
    data = np.full((4, 4, len(ti)), 10.0, np.float32)
    with pytest.raises(RuntimeError, match='non-finite'):
        tf.local_qdm_bc(data, _grid(4), 'ws', 'u_100m', fp,
                        jax_tf.get_date_range_kwargs(ti))


def _h5_to_nc(h5_path, nc_path):
    with h5py.File(h5_path, 'r') as f:
        ll = np.dstack([f['latitude'][:], f['longitude'][:]])
        rasters = {k: f[k][:] for k in f if k not in ('latitude',
                                                       'longitude')}
        cfg = json.loads(f.attrs['cfg'])
    return write_nc_factor_file(nc_path, ll, rasters, cfg)


def test_factor_file_h5_and_netcdf3_give_equal_rasters(tmp_path):
    """One factor file read as H5 (h5py) and as NetCDF3 (scipy) gives
    the same window rasters, cfg and chunk correction; the window is
    found from the chunk's south-west corner."""
    h5 = _qdm_file(str(tmp_path / 'qdm.h5'), with_presrat=True, k=1.2,
                   tau=0.5)
    nc = _h5_to_nc(h5, str(tmp_path / 'qdm.nc'))
    with open(nc, 'rb') as f:
        assert f.read(3) == b'CDF'
    ll = _grid(10)[2:7, 3:9]
    names = {'base': 'base_ws_params', 'bias': 'bias_u_100m_params',
             'bias_fut': 'bias_fut_u_100m_params',
             'k': 'u_100m_k_factor', 'tau': 'u_100m_tau_fut'}
    a = tf._read_factor_file(h5, names, ll)
    b = tf._read_factor_file(nc, names, ll)
    j = jax_tf._read_factor_file(h5, names, ll)
    assert a['cfg'] == b['cfg'] == j['cfg']
    for k in names:
        assert a[k].shape == (5, 6) + a[k].shape[2:]
        assert b[k].dtype == a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], j[k])
    assert sorted(tf.factor_file_variables(nc)) == sorted(
        tf.factor_file_variables(h5))
    ti = pd.date_range('2015-05-01', periods=8, freq='D')
    kws = tf.get_date_range_kwargs(TimeIndex(ti.values))
    data = np.random.default_rng(6).normal(11, 1, (5, 6, 8)).astype(
        np.float32)
    out = [tf.local_presrat_bc(data, ll, 'ws', 'u_100m', fp, kws,
                               relative=False) for fp in (h5, nc)]
    np.testing.assert_array_equal(out[0], out[1])
