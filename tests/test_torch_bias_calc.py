"""The bias calibrations of the port against the JAX package on the
fixtures of tests/bias/: the linear family and ``SkillAssessment``, the
QDM and PresRat host ``run`` (rtol 1e-6), their torch device path run
on the CPU in these tests (against the JAX package's jitted path and the host path
at rtol 2e-4 / atol 2e-2 with equal NaN masks), the ``nanquantile`` row
split, a gridded NetCDF baseline, the handler-level ``lin_bc`` /
``qdm_bc`` (H5 and NetCDF3 factor files) and the Vortex prepper on small
TIFs."""

import json

import h5py
import numpy as np
import pytest
import torch

import sup3r_tpu.bias as jax_bias
import sup3r_tpu_torch.bias as bias
import sup3r_tpu_torch.bias.qdm as qdm_mod
from sup3r_tpu.preprocessing.data_handlers import DataHandler as JaxHandler
from sup3r_tpu.utilities.test_helpers import (
    make_fake_h5_file,
    make_fake_nc_file,
)
from sup3r_tpu_torch.preprocessing.data_handlers import DataHandler
from sup3r_tpu_torch.utilities.test_helpers import write_nc_factor_file
from tests.bias import test_handler_bc as handler_bc
from tests.bias.test_bias_correction import paired_files  # noqa: F401
from tests.bias.test_presrat_device import KW as PRESRAT_KW
from tests.bias.test_presrat_device import presrat_files  # noqa: F401
from tests.bias.test_qdm_device import qdm_calc  # noqa: F401
from tests.bias.test_vortex import _make_tifs

torch.set_num_threads(1)

RTOL = 1e-6
DEV_RTOL, DEV_ATOL = 2e-4, 2e-2


def _same(got, want, rtol=RTOL, atol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]),
                                      err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize('name,kwargs,run_kwargs', [
    ('LinearCorrection', {}, {'fill_extend': False}),
    ('LinearCorrection', {'match_zero_rate': True}, {'max_workers': 3}),
    ('ScalarCorrection', {'decimals': 2}, {'smooth_interior': 1.0}),
    ('MonthlyLinearCorrection', {}, {'smooth_extend': 0.5}),
    ('MonthlyScalarCorrection', {}, {'daily_reduction': 'max'}),
    ('SkillAssessment', {}, {}),
], ids=['linear', 'linear_zero_rate_threads', 'scalar_decimals',
        'monthly_linear', 'monthly_scalar_max', 'skill'])
def test_linear_family_matches_jax(paired_files, tmp_path, name,  # noqa
                                   kwargs, run_kwargs):
    base_fp, bias_fp = paired_files
    args = (base_fp, bias_fp, 'windspeed_100m', 'u_100m')
    fps = {}
    outs = {}
    for pkg, mod in (('port', bias), ('jax', jax_bias)):
        fps[pkg] = str(tmp_path / f'{pkg}.h5')
        outs[pkg] = getattr(mod, name)(*args, **kwargs).run(
            fp_out=fps[pkg], **run_kwargs)
    _same(outs['port'], outs['jax'])
    with h5py.File(fps['port'], 'r') as fp, h5py.File(fps['jax'],
                                                      'r') as fj:
        assert set(fp) == set(fj)
        for k in fj:
            np.testing.assert_allclose(fp[k][:], fj[k][:], rtol=RTOL,
                                       equal_nan=True)
        assert json.loads(fp.attrs['cfg']) == json.loads(fj.attrs['cfg'])


def test_nc_baseline_matches_jax(tmp_path):
    """A gridded NetCDF baseline through ``LoaderNC`` and the flat gid
    adapter (test_nc_base_file), hourly, with the daily reduction."""
    base_fp = make_fake_nc_file(
        str(tmp_path / 'base.nc'), (12, 12, 24 * 40), ['u_100m'],
        freq='h', lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3))
    bias_fp = make_fake_nc_file(
        str(tmp_path / 'bias.nc'), (6, 6, 40), ['u_100m'], freq='D',
        lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3))
    outs = [mod.ScalarCorrection(base_fp, bias_fp, 'u_100m', 'u_100m',
                                 base_handler='LoaderNC').run()
            for mod in (bias, jax_bias)]
    _same(*outs)


def test_fill_and_smooth_matches_jax():
    rng = np.random.default_rng(0)
    arr = rng.random((8, 8, 2)).astype(np.float32)
    arr[2:4, 2:4, :] = np.nan
    for kw in ({'fill_extend': True}, {'fill_extend': False,
                                       'smooth_interior': 1.0},
               {'smooth_extend': 0.7, 'smooth_interior': 0.4}):
        got = bias.LinearCorrection.fill_and_smooth(
            None, {'k': arr.copy()}, **kw)
        want = jax_bias.LinearCorrection.fill_and_smooth(
            None, {'k': arr.copy()}, **kw)
        _same(got, want)


def _qdm_pair(calc, **kwargs):
    """The port's calibration on the JAX fixture's files and settings."""
    return bias.QuantileDeltaMappingCorrection(
        calc.base_fps, calc.bias_fps, calc.bias_fut_dh.file_paths,
        calc.base_dset, calc.bias_feature, n_quantiles=calc.n_quantiles,
        n_time_steps=calc.n_time_steps, device='cpu', **kwargs)


@pytest.mark.parametrize('run_kwargs', [
    {'fill_extend': False}, {'smooth_interior': 0.8, 'max_workers': 2}],
    ids=['nan_kept', 'filled_threads'])
def test_qdm_host_run_matches_jax(qdm_calc, tmp_path, run_kwargs):  # noqa
    port = _qdm_pair(qdm_calc)
    assert port._resolve_use_device(None) is False
    got = port.run(fp_out=str(tmp_path / 'port.h5'), **run_kwargs)
    want = qdm_calc.run(fp_out=str(tmp_path / 'jax.h5'), **run_kwargs)
    _same(got, want)
    with h5py.File(tmp_path / 'port.h5', 'r') as fp, \
            h5py.File(tmp_path / 'jax.h5', 'r') as fj:
        assert json.loads(fp.attrs['cfg']) == json.loads(fj.attrs['cfg'])


def test_qdm_device_path_matches_jax_and_host(qdm_calc):  # noqa
    """``run(use_device=True)`` in torch (on the CPU) against the
    JAX package's jitted path and the port's host path."""
    port = _qdm_pair(qdm_calc)
    got = port.run(fill_extend=False, use_device=True)
    _same(got, qdm_calc.run(fill_extend=False, use_device=True),
          DEV_RTOL, DEV_ATOL)
    _same(got, port.run(fill_extend=False, use_device=False), DEV_RTOL,
          DEV_ATOL)


def test_nanquantile_row_split_equals_unsplit(qdm_calc, monkeypatch):  # noqa
    """torch refuses quantile inputs past 2 ** 24 elements, so the padded
    window tensor goes in row blocks under ``NANQUANTILE_MAX_ELEMENTS``;
    a cap of a few rows gives the unsplit result."""
    port = _qdm_pair(qdm_calc)
    arr = port.bias_dh.data['rsds']
    whole = port._windowed_params_raster(arr, port.bias_time_index,
                                         use_device=True)
    idx, _ = port._window_index_matrix(port.bias_time_index)
    calls = []
    real = torch.nanquantile

    def counted(*args, **kwargs):
        calls.append(args[0].numel())
        return real(*args, **kwargs)

    monkeypatch.setattr(qdm_mod, 'NANQUANTILE_MAX_ELEMENTS',
                        3 * idx.shape[1] + 1)
    monkeypatch.setattr(torch, 'nanquantile', counted)
    split = port._windowed_params_raster(arr, port.bias_time_index,
                                         use_device=True)
    n_rows = arr.shape[0] * arr.shape[1] * port.n_time_steps
    assert len(calls) == -(-n_rows // 3)
    assert max(calls) <= qdm_mod.NANQUANTILE_MAX_ELEMENTS
    np.testing.assert_array_equal(split, whole)


def _presrat_pair(files):
    return [mod.PresRat(*files, 'pr', 'pr', **PRESRAT_KW, **dev)
            for mod, dev in ((bias, {'device': 'cpu'}), (jax_bias, {}))]


def test_presrat_host_run_matches_jax(presrat_files, tmp_path):  # noqa
    port, jax = _presrat_pair(presrat_files)
    got = port.run(fp_out=str(tmp_path / 'port.h5'), fill_extend=False)
    want = jax.run(fp_out=str(tmp_path / 'jax.h5'), fill_extend=False)
    _same(got, want)
    with h5py.File(tmp_path / 'port.h5', 'r') as fp, \
            h5py.File(tmp_path / 'jax.h5', 'r') as fj:
        assert json.loads(fp.attrs['cfg']) == json.loads(fj.attrs['cfg'])


def test_presrat_device_path_matches_jax_and_host(presrat_files):  # noqa
    """The torch device path (percentiles and the batched QDM of the
    future series) against the JAX package's jitted path and the host
    path; the JAX package's own 99.9th-percentile bar on the relative
    error holds too (tests/bias/test_presrat_device.py)."""
    port, jax = _presrat_pair(presrat_files)
    got = port.run(fill_extend=False, use_device=True)
    for want in (jax.run(fill_extend=False, use_device=True),
                 port.run(fill_extend=False, use_device=False)):
        _same(got, want, DEV_RTOL, DEV_ATOL)
        for key in want:
            w, g = want[key], got[key]
            ok = np.isfinite(w)
            rel = np.abs(g[ok] - w[ok]) / np.maximum(np.abs(w[ok]), 1e-12)
            tol = 5e-4 if key.endswith('_tau_fut') else 2e-4
            assert np.quantile(rel, 0.999) < tol, (key, rel.max())


def test_device_work_stays_on_the_calling_thread(presrat_files,  # noqa
                                                 monkeypatch):
    """The threaded gid loop does host work only: every torch call of
    the device path runs on the calling thread (``exact_fp32`` and the
    card's streams are per process), and threads change no result."""
    import threading

    import sup3r_tpu_torch.bias.presrat as presrat_mod

    threads = []
    real_q, real_t = torch.nanquantile, presrat_mod.qdm_transform_device

    def on_thread(fn):
        def call(*args, **kwargs):
            threads.append(threading.get_ident())
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(torch, 'nanquantile', on_thread(real_q))
    monkeypatch.setattr(presrat_mod, 'qdm_transform_device',
                        on_thread(real_t))
    port, _ = _presrat_pair(presrat_files)
    threaded = port.run(fill_extend=False, use_device=True, max_workers=4)
    assert threads and set(threads) == {threading.get_ident()}
    _same(threaded, port.run(fill_extend=False, use_device=True), 0.0)


def test_presrat_partial_year_keeps_nan_windows(tmp_path):
    """Windows the biased history does not cover stay NaN on both paths
    and in both packages."""
    base_fp = make_fake_h5_file(
        str(tmp_path / 'base.h5'), (6, 6, 24 * 360), ['pr'],
        freq='h', value_range=(0, 5e-4), scale_factor=1e7,
        lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3))
    bias_fp = make_fake_nc_file(
        str(tmp_path / 'hist.nc'), (3, 3, 180), ['pr'], freq='D',
        lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3))
    fut_fp = make_fake_nc_file(
        str(tmp_path / 'fut.nc'), (3, 3, 360), ['pr'], freq='D',
        lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3))
    port, jax = _presrat_pair((base_fp, bias_fp, fut_fp))
    host = port.run(fill_extend=False)
    _same(host, jax.run(fill_extend=False))
    assert np.isnan(host['pr_k_factor']).any()
    dev = port.run(fill_extend=False, use_device=True)
    _same(dev, jax.run(fill_extend=False, use_device=True), DEV_RTOL,
          DEV_ATOL)


def test_calibrations_default_to_the_card(qdm_calc, monkeypatch):  # noqa
    """Without ``device`` a calibration takes the card and raises when
    there is none; ``device='cpu'`` keeps ``use_device=None`` on the
    host path, and ``use_device=True`` runs the torch path there."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bias.QuantileDeltaMappingCorrection(
            qdm_calc.base_fps, qdm_calc.bias_fps,
            qdm_calc.bias_fut_dh.file_paths, 'ghi', 'rsds')
    port = _qdm_pair(qdm_calc)
    assert port.device.type == 'cpu'
    assert port._resolve_use_device(None) is False
    assert port._resolve_use_device(True) is True


def test_zero_precipitation_rate_matches_jax():
    from sup3r_tpu.bias.presrat import zero_precipitation_rate as jax_zr
    from sup3r_tpu_torch.bias.presrat import zero_precipitation_rate

    arr = np.array([0.0, 0.5, np.nan, 1.0, 2.0, np.inf])
    for thr in (0.0, 0.5, 5.0):
        assert zero_precipitation_rate(arr, thr) == jax_zr(arr, thr)
    assert np.isnan(zero_precipitation_rate(np.full(3, np.nan)))


def _handlers(tmp_path, **kwargs):
    path = make_fake_nc_file(
        str(tmp_path / 'input.nc'), (handler_bc.S, handler_bc.S, 30),
        ['u100', 'v100'], start='2019-11-16', freq='D',
        lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3))
    return (DataHandler(path, features=['u_100m', 'v_100m']),
            JaxHandler(path, features=['u_100m', 'v_100m']))


def _linear_factor_file(tmp_path, handler, depth):
    rng = np.random.default_rng(depth)
    ll = np.asarray(handler.lat_lon)
    fp = str(tmp_path / f'lin_{depth}.h5')
    with h5py.File(fp, 'w') as f:
        f.create_dataset('latitude', data=ll[..., 0])
        f.create_dataset('longitude', data=ll[..., 1])
        f.create_dataset('u_100m_scalar', data=rng.uniform(
            0.5, 1.5, ll.shape[:2] + (depth,)).astype(np.float32))
        f.create_dataset('u_100m_adder', data=rng.normal(
            0, 1, ll.shape[:2] + (depth,)).astype(np.float32))
    return fp


def _to_nc(h5_path):
    with h5py.File(h5_path, 'r') as f:
        ll = np.dstack([f['latitude'][:], f['longitude'][:]])
        rasters = {k: f[k][:] for k in f
                   if k not in ('latitude', 'longitude')}
        cfg = json.loads(f.attrs['cfg']) if 'cfg' in f.attrs else {}
    return write_nc_factor_file(h5_path.replace('.h5', '.nc'), ll,
                                rasters, cfg)


@pytest.mark.parametrize('fmt', ['h5', 'netcdf3'])
@pytest.mark.parametrize('depth', [1, 12], ids=['annual', 'monthly'])
def test_lin_bc_matches_jax(tmp_path, depth, fmt):
    port, jax = _handlers(tmp_path)
    fp = _linear_factor_file(tmp_path, port, depth)
    fp_port = fp if fmt == 'h5' else _to_nc(fp)
    assert bias.lin_bc(port, fp_port) == jax_bias.lin_bc(jax, fp) == [
        'u_100m']
    for f in ('u_100m', 'v_100m'):
        np.testing.assert_allclose(port.data[f], np.asarray(jax.data[f]),
                                   rtol=RTOL)


@pytest.mark.parametrize('fmt', ['h5', 'netcdf3'])
def test_qdm_bc_matches_jax(tmp_path, fmt):
    port, jax = _handlers(tmp_path)
    fp = handler_bc._qdm_file(tmp_path)
    fp_port = fp if fmt == 'h5' else _to_nc(fp)
    kw = dict(relative=False, delta_range=(-5.0, 5.0))
    assert bias.qdm_bc(port, fp_port, 'ws', **kw) == jax_bias.qdm_bc(
        jax, fp, 'ws', **kw) == ['u_100m']
    for f in ('u_100m', 'v_100m'):
        np.testing.assert_allclose(port.data[f], np.asarray(jax.data[f]),
                                   rtol=RTOL)


def test_vortex_matches_jax(tmp_path):
    """VortexMeanPrepper on small TIFs with world files, then
    BiasCorrectUpdate of an H5 output with its monthly factors: the
    written files equal the JAX package's."""
    pattern = _make_tifs(tmp_path, shape=(5, 4))
    for fp in tmp_path.glob('*.tif'):
        fp.with_suffix('.tfw').write_text(
            '0.1\n0\n0\n-0.1\n-105.0\n40.0\n')
    outs = {}
    for pkg, mod in (('port', bias), ('jax', jax_bias)):
        outs[pkg] = mod.VortexMeanPrepper.run(
            pattern, [10, 100], [10, 40, 100], str(tmp_path / f'{pkg}.h5'))
    with h5py.File(outs['port'], 'r') as fp, h5py.File(outs['jax'],
                                                       'r') as fj:
        assert set(fp) == set(fj)
        for k in fj:
            np.testing.assert_array_equal(fp[k][:], fj[k][:], err_msg=k)
            assert dict(fp[k].attrs).keys() == dict(fj[k].attrs).keys()
    in_file = make_fake_h5_file(str(tmp_path / 'final.h5'), (4, 4, 24 * 70),
                                ['windspeed_100m'], start='2023-01-01')
    bc_file = str(tmp_path / 'factors.h5')
    with h5py.File(bc_file, 'w') as f:
        f.create_dataset('windspeed_100m_scalar', data=np.random.default_rng(
            0).uniform(0.5, 2, (4, 4, 12)).astype(np.float32))
    for pkg, mod in (('port', bias), ('jax', jax_bias)):
        mod.BiasCorrectUpdate.run(in_file, str(tmp_path / f'{pkg}_bc.h5'),
                                  'windspeed_100m', bc_file,
                                  global_scalar=1.1)
    with h5py.File(tmp_path / 'port_bc.h5', 'r') as fp, \
            h5py.File(tmp_path / 'jax_bc.h5', 'r') as fj:
        np.testing.assert_array_equal(fp['windspeed_100m'][:],
                                      fj['windspeed_100m'][:])
