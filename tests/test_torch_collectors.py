"""The port's collectors (``sup3r_tpu_torch.postprocessing.collectors``)
against the JAX package's on the fixtures of tests/output/
test_collectors.py and test_output_handling.py: chunk files written by
the JAX writers, collected by both packages. The collected H5 files hold
equal datasets, meta, time indexes and attributes; the collected NetCDF
files equal variables (data, coordinates and times). Each refusal
raises in both packages with the same message."""

import os
import shutil

import h5py
import numpy as np
import pandas as pd
import pytest
from scipy.io import netcdf_file

from sup3r_tpu.postprocessing import collectors as jax_collectors
from sup3r_tpu.postprocessing.writers import OutputHandlerNC
from sup3r_tpu.utilities import RANDOM_GENERATOR
from sup3r_tpu_torch.postprocessing import collectors as port_collectors
from sup3r_tpu_torch.preprocessing.loaders import LoaderNC
from tests.output.test_collectors import _write_chunks
from tests.output.test_output_handling import _curvi_grid, _grid

PACKAGES = (('port', port_collectors), ('jax', jax_collectors))


def _assert_h5_equal(got, want):
    with h5py.File(got, 'r') as fg, h5py.File(want, 'r') as fw:
        assert set(fg) == set(fw)
        for k in fw:
            np.testing.assert_array_equal(fg[k][:], fw[k][:], err_msg=k)
            assert fg[k].dtype == fw[k].dtype, k
            np.testing.assert_equal(dict(fg[k].attrs), dict(fw[k].attrs))
        np.testing.assert_equal(dict(fg.attrs), dict(fw.attrs))


def _assert_nc_equal(got, want):
    with netcdf_file(got, 'r', mmap=False) as fg, \
            netcdf_file(want, 'r', mmap=False) as fw:
        assert set(fg.variables) == set(fw.variables)
        for k, v in fw.variables.items():
            np.testing.assert_array_equal(fg.variables[k].data, v.data,
                                          err_msg=k)
            assert fg.variables[k].dimensions == v.dimensions


def _collect_h5_both(tmp_path, chunks, **kwargs):
    outs = {}
    for name, mod in PACKAGES:
        outs[name] = str(tmp_path / f'{name}.h5')
        mod.CollectorH5.collect(chunks, outs[name], **kwargs)
    _assert_h5_equal(outs['port'], outs['jax'])
    return outs['port']


def _read_scaled(fp, feature='windspeed_100m'):
    with h5py.File(fp, 'r') as f:
        return (f[feature][:] / f[feature].attrs['scale_factor'],
                f['meta'][:])


def _target_csv(tmp_path, lat, lon, name='target.csv'):
    fp = str(tmp_path / name)
    pd.DataFrame({'latitude': lat, 'longitude': lon}).to_csv(
        fp, index=False)
    return fp


@pytest.mark.parametrize('kwargs', [
    {}, {'max_workers': 1}, {'max_workers': 4, 'n_writes': 2},
    {'n_writes': 1}, {'features': ['windspeed_100m']}])
def test_collect_h5_matches_jax(tmp_path, kwargs):
    chunks, truth, *_ = _write_chunks(tmp_path)
    out = _collect_h5_both(tmp_path, chunks, **kwargs)
    ws, meta = _read_scaled(out)
    assert len(meta) == truth.shape[1]
    np.testing.assert_allclose(ws, truth, atol=0.01)


def test_collect_h5_n_writes_over_temporal_chunks(tmp_path):
    """Four temporal chunks, three write groups: one file either way."""
    s1, s2, t = 4, 4, 8
    from sup3r_tpu.postprocessing.writers import OutputHandlerH5

    data = (RANDOM_GENERATOR.random((s1, s2, t, 1)) * 10).astype(
        np.float32)
    lat_lon = _grid(s1, s2)
    times = pd.date_range('2023-01-01', periods=t, freq='h')
    gids = np.arange(s1 * s2).reshape(s1, s2)
    chunks = []
    for t_idx in range(4):
        fp = str(tmp_path / f'chunk_{t_idx:06d}_000000.h5')
        ts = slice(2 * t_idx, 2 * t_idx + 2)
        OutputHandlerH5._write_output(
            data[:, :, ts].copy(), ['windspeed_100m'], lat_lon,
            times[ts], fp, gids=gids)
        chunks.append(fp)
    out = _collect_h5_both(tmp_path, chunks, n_writes=3)
    one = str(tmp_path / 'one.h5')
    port_collectors.CollectorH5.collect(chunks, one)
    _assert_h5_equal(out, one)


def test_flist_chunk_planning_matches_jax(tmp_path):
    chunks, *_ = _write_chunks(tmp_path)
    port = port_collectors.CollectorH5(chunks)
    jax = jax_collectors.CollectorH5(chunks)
    assert port.flist == jax.flist
    for n in (None, 1, 2, 10):
        assert port.get_flist_chunks(n) == jax.get_flist_chunks(n)
    for g in port.get_flist_chunks(10):
        assert len({port_collectors.get_chunk_indices(fp)[0]
                    for fp in g}) == 1


def test_target_meta_masking_matches_jax(tmp_path):
    chunks, truth, lat_lon, _, _ = _write_chunks(tmp_path)
    keep = np.arange(0, lat_lon[..., 0].size, 3)
    tm = _target_csv(tmp_path, lat_lon[..., 0].ravel()[keep],
                     lat_lon[..., 1].ravel()[keep])
    out = _collect_h5_both(tmp_path, chunks, target_meta_file=tm)
    ws, meta = _read_scaled(out)
    np.testing.assert_array_equal(np.sort(meta['gid']), keep)
    order = np.argsort(meta['gid'])
    np.testing.assert_allclose(ws[:, order], truth[:, keep], atol=0.01)


def test_target_meta_table_and_no_match(tmp_path):
    """A target given as a table masks like its CSV; a target far from
    every coordinate is refused by both packages."""
    chunks, _, lat_lon, _, _ = _write_chunks(tmp_path)
    keep = np.arange(0, lat_lon[..., 0].size, 5)
    lat, lon = lat_lon[..., 0].ravel()[keep], lat_lon[..., 1].ravel()[keep]
    a, b = str(tmp_path / 'a.h5'), str(tmp_path / 'b.h5')
    port_collectors.CollectorH5.collect(
        chunks, a, target_meta_file={'latitude': lat, 'longitude': lon})
    port_collectors.CollectorH5.collect(
        chunks, b, target_meta_file=_target_csv(tmp_path, lat, lon))
    _assert_h5_equal(a, b)
    far = _target_csv(tmp_path, [10.0], [50.0], 'far.csv')
    for _, mod in PACKAGES:
        with pytest.raises(RuntimeError, match='No target coordinates'):
            mod.CollectorH5.collect(chunks, str(tmp_path / 'x.h5'),
                                    target_meta_file=far)


def test_chunk_outside_target_warns_and_skips(tmp_path):
    chunks, truth, lat_lon, _, gids = _write_chunks(tmp_path)
    quad = gids[:4, :4].ravel()
    tm = _target_csv(tmp_path, lat_lon[..., 0].ravel()[quad],
                     lat_lon[..., 1].ravel()[quad])
    with pytest.warns(UserWarning, match='No target coordinates'):
        out = _collect_h5_both(tmp_path, chunks, target_meta_file=tm,
                               max_workers=1)
    ws, meta = _read_scaled(out)
    order = np.argsort(meta['gid'])
    np.testing.assert_allclose(ws[:, order], truth[:, np.sort(quad)],
                               atol=0.01)


def test_duplicate_chunk_files_deduped(tmp_path):
    chunks, truth, *_ = _write_chunks(tmp_path)
    dup = str(tmp_path / 'dupjob_000000_000000.h5')
    shutil.copy(chunks[0], dup)
    files = [dup, *chunks]
    assert (port_collectors.get_unique_chunk_files(files)
            == jax_collectors.get_unique_chunk_files(files))
    out = _collect_h5_both(tmp_path, files)
    np.testing.assert_allclose(_read_scaled(out)[0], truth, atol=0.01)


def test_scale_factor_harmonization(tmp_path):
    chunks, truth, *_ = _write_chunks(tmp_path)
    with h5py.File(chunks[0], 'r+') as f:
        raw = f['windspeed_100m'][:]
        vals = raw.astype(np.float32) / f['windspeed_100m'].attrs[
            'scale_factor']
        del f['windspeed_100m']
        ds = f.create_dataset('windspeed_100m', data=np.round(
            vals * 10.0).astype(raw.dtype))
        ds.attrs['scale_factor'] = 10.0
    out = _collect_h5_both(tmp_path, chunks, max_workers=1)
    np.testing.assert_allclose(_read_scaled(out)[0], truth, atol=0.06)


@pytest.mark.parametrize('name', [
    'chunk_000001_000003.h5', 'era5_202401_x_000002_000005.nc',
    'sup3r_chunk_000000_000000_irradiance.h5', 'not_a_chunk_file.h5'])
def test_get_chunk_indices_matches_jax(name):
    try:
        want = jax_collectors.get_chunk_indices(name)
    except ValueError:
        with pytest.raises(ValueError, match='chunk ids'):
            port_collectors.get_chunk_indices(name)
        return
    assert port_collectors.get_chunk_indices(name) == want


def test_collect_overwrite_false_skips(tmp_path):
    fps, *_ = _write_chunks(tmp_path)
    out = str(tmp_path / 'collected.h5')
    port_collectors.CollectorH5.collect(fps, out)
    mtime = os.path.getmtime(out)
    port_collectors.CollectorH5.collect(fps, out, overwrite=False)
    assert os.path.getmtime(out) == mtime


def _nc_chunks(tmp_path, data, lat_lon, times, feats, t_splits, s_splits,
               axis=0):
    chunks = []
    for t_idx, ts in enumerate(t_splits):
        for s_idx, ss in enumerate(s_splits):
            sel = (ss, slice(None)) if axis == 0 else (slice(None), ss)
            fp = str(tmp_path / f'chunk_{t_idx:06d}_{s_idx:06d}.nc')
            OutputHandlerNC._write_output(
                data[sel][:, :, ts].copy(), feats, lat_lon[sel],
                times[ts], fp)
            chunks.append(fp)
    return chunks


def _collect_nc_both(tmp_path, chunks, **kwargs):
    outs = {}
    for name, mod in PACKAGES:
        outs[name] = str(tmp_path / f'{name}.nc')
        mod.CollectorNC.collect(chunks, outs[name], **kwargs)
    _assert_nc_equal(outs['port'], outs['jax'])
    return outs['port']


@pytest.mark.parametrize('max_workers', [None, 1])
def test_collect_nc_matches_jax(tmp_path, max_workers):
    """A regular grid split over both axes and time."""
    s1, s2, t = 6, 6, 4
    data = RANDOM_GENERATOR.random((s1, s2, t, 2)).astype(np.float32)
    times = pd.date_range('2023-01-01', periods=t, freq='h')
    chunks = _nc_chunks(tmp_path, data, _grid(s1, s2), times,
                        ['u_100m', 'v_100m'], [slice(0, 2), slice(2, 4)],
                        [slice(0, 3), slice(3, 6)])
    out = _collect_nc_both(tmp_path, chunks, max_workers=max_workers)
    dset = LoaderNC(out).data
    np.testing.assert_allclose(dset['u_100m'], data[..., 0], atol=1e-4)
    assert dset.time_index.equals(times.values)


def test_collect_nc_curvilinear_matches_jax(tmp_path):
    s1, s2, t = 9, 5, 6
    data = RANDOM_GENERATOR.random((s1, s2, t, 2)).astype(np.float32)
    lat_lon = _curvi_grid(s1, s2)
    times = pd.date_range('2023-01-01', periods=t, freq='h')
    feats = ['u_100m', 'v_100m']
    chunks = _nc_chunks(tmp_path, data, lat_lon, times, feats,
                        [slice(0, 3), slice(3, 6)],
                        [slice(0, 3), slice(3, 6), slice(6, 9)])
    for _, mod in PACKAGES:
        with pytest.raises(NotImplementedError, match='is_regular_grid'):
            mod.CollectorNC.collect(chunks, str(tmp_path / 'bad.nc'))
    out = _collect_nc_both(tmp_path, chunks, is_regular_grid=False)
    dset = LoaderNC(out).data
    np.testing.assert_array_equal(dset.lat_lon, lat_lon)
    np.testing.assert_array_equal(dset.time_index.values, times.values)
    for k, f in enumerate(feats):
        np.testing.assert_array_equal(np.asarray(dset[f]), data[..., k])


def test_collect_nc_curvilinear_refusals(tmp_path):
    """A west_east mismatch, a missing temporal chunk and a longitude
    split are refused by both packages with the same message."""
    s1, s2, t = 9, 5, 6
    data = RANDOM_GENERATOR.random((s1, s2, t, 1)).astype(np.float32)
    lat_lon = _curvi_grid(s1, s2)
    times = pd.date_range('2023-01-01', periods=t, freq='h')
    chunks = _nc_chunks(tmp_path, data, lat_lon, times, ['u_100m'],
                        [slice(0, 3), slice(3, 6)],
                        [slice(0, 3), slice(3, 6), slice(6, 9)])
    bad = str(tmp_path / 'chunk_000000_000003.nc')
    OutputHandlerNC._write_output(data[:3, :4, :3].copy(), ['u_100m'],
                                  lat_lon[:3, :4], times[:3], bad)
    wide = _curvi_grid(6, 8)
    (tmp_path / 'lon').mkdir()
    lon_split = _nc_chunks(tmp_path / 'lon', RANDOM_GENERATOR.random(
        (6, 8, 3, 1)).astype(np.float32), wide, times[:3], ['u_100m'],
        [slice(0, 3)], [slice(0, 4), slice(4, 8)], axis=1)
    cases = (([*chunks, bad], NotImplementedError, 'west_east'),
             (chunks[:-1], ValueError, 'different time'),
             (lon_split, NotImplementedError, 'monotonic'))
    for files, err, match in cases:
        msgs = []
        for _, mod in PACKAGES:
            with pytest.raises(err, match=match) as info:
                mod.CollectorNC.collect(files, str(tmp_path / 'x.nc'),
                                        is_regular_grid=False)
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]


def test_collector_nc_empty_glob_is_loud(tmp_path):
    for _, mod in PACKAGES:
        with pytest.raises(AssertionError, match='No chunk files'):
            mod.CollectorNC.collect(str(tmp_path / 'nope_*.nc'),
                                    str(tmp_path / 'out.nc'))
        with pytest.raises(AssertionError, match='No chunk files'):
            mod.CollectorNC.collect([], str(tmp_path / 'out.nc'))
