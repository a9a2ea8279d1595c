"""The slice as a whole: the port's chunked ``ForwardPass`` against the
JAX package's on the non-exo, single-device fixtures of
tests/forward_pass/test_forward_pass.py, test_batched_fwp.py and
test_boundary_chunks.py — the same input files and the same weights
(a JAX ``save`` read by the port's ``load``), through the serial and the
device-batched paths and both drains. Arrays and NetCDF output agree
within 1e-4 of their largest magnitude; H5 output within one int16
storage quantum, with equal meta, time_index and dataset attrs. Every
option a later slice brings raises ``NotImplementedError``; those of the
streaming slice (``chunked_io``, the GCM handlers, ``mode='lazy'``) and
bias correction run and match the JAX package."""

import glob
import json
import os
import warnings

import h5py
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
from sup3r_tpu.preprocessing import DataHandler as JaxDataHandler
from sup3r_tpu.utilities.test_helpers import (
    make_fake_h5_file,
    make_fake_nc_file,
)
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import DataHandler
from tests.forward_pass import test_boundary_chunks as boundary
from tests.forward_pass.test_forward_pass import (
    _pointwise_gen_config,
    _s_gen_config,
    _save_model,
    _st_gen_config,
)

torch.set_num_threads(1)

RTOL = 1e-4


@pytest.fixture(scope='module')
def saved(tmp_path_factory):
    """JAX save directories of the fixtures' generators."""
    root = tmp_path_factory.mktemp('models')
    return {
        'st': _save_model(str(root / 'st'), _st_gen_config(), 3, 4)[0],
        'pointwise': _save_model(str(root / 'pw'), _pointwise_gen_config(),
                                 3, 4)[0],
        'spatial': _save_model(str(root / 's'), _s_gen_config(), 2, 1,
                               is_5d=False)[0],
        'boundary': boundary._save_model(str(root / 'b')),
    }


def _close(got, want, what):
    tol = RTOL * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol, (what, err, tol)


def _compare_nc(port_dir, jax_dir):
    files = sorted(os.listdir(jax_dir))
    assert files and sorted(os.listdir(port_dir)) == files
    for name in files:
        with netcdf_file(os.path.join(port_dir, name), 'r',
                         mmap=False) as fp, \
                netcdf_file(os.path.join(jax_dir, name), 'r',
                            mmap=False) as fj:
            assert set(fp.variables) == set(fj.variables)
            for var in fj.variables:
                _close(fp.variables[var].data, fj.variables[var].data,
                       (name, var))


def _compare_h5(port_dir, jax_dir):
    files = sorted(os.listdir(jax_dir))
    assert files and sorted(os.listdir(port_dir)) == files
    for name in files:
        with h5py.File(os.path.join(port_dir, name)) as fp, \
                h5py.File(os.path.join(jax_dir, name)) as fj:
            assert set(fp) == set(fj)
            np.testing.assert_array_equal(fp['meta'][:], fj['meta'][:])
            np.testing.assert_array_equal(fp['time_index'][:],
                                          fj['time_index'][:])
            for var in set(fj) - {'meta', 'time_index'}:
                got, want = fp[var][:], fj[var][:]
                assert got.dtype == want.dtype, var
                diff = got.astype(np.int64) - want.astype(np.int64)
                assert np.abs(diff).max() <= 1, (name, var)
                np.testing.assert_equal(dict(fp[var].attrs),
                                        dict(fj[var].attrs))


def _run_both(tmp_path, model_dir, nodes=(0,), suffix=None, **kwargs):
    """Run both packages' ForwardPass on the same kwargs; returns the
    two outputs (``{chunk: array}``) or compares the written files."""
    results = []
    for name, Strategy, Fwp, mkw in (
            ('port', ForwardPassStrategy, ForwardPass,
             {'model_dir': model_dir, 'device': 'cpu'}),
            ('jax', JaxStrategy, JaxForwardPass, {'model_dir': model_dir})):
        kw = dict(kwargs)
        if suffix is not None:
            kw['out_pattern'] = str(tmp_path / name / f'c_{{file_id}}.'
                                    f'{suffix}')
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            strategy = Strategy(model_kwargs=mkw, **kw)
            out = {}
            for node in nodes:
                out.update(Fwp.run(strategy, node) or {})
        results.append((strategy, out))
    (port_strategy, port), (jax_strategy, jax_out) = results
    assert port_strategy.fwp_slicer.n_chunks == \
        jax_strategy.fwp_slicer.n_chunks
    if suffix == 'nc':
        _compare_nc(tmp_path / 'port', tmp_path / 'jax')
    elif suffix == 'h5':
        _compare_h5(tmp_path / 'port', tmp_path / 'jax')
    else:
        assert sorted(port) == sorted(jax_out) and port
        for idx in jax_out:
            assert port[idx].shape == jax_out[idx].shape
            _close(port[idx], jax_out[idx], idx)
    return port_strategy, port


def _nc_input(tmp_path, shape=(12, 12, 8), features=('u100', 'v100')):
    return make_fake_nc_file(str(tmp_path / 'input.nc'), shape,
                             list(features))


def test_pointwise_stitching(tmp_path, saved):
    """test_fwp_stitching_exact_pointwise: the port's chunked output is
    the JAX package's, and stitches to the full-domain run."""
    kw = dict(file_paths=_nc_input(tmp_path), fwp_chunk_shape=(5, 7, 3),
              spatial_pad=2, temporal_pad=2, out_pattern=None)
    strategy, outputs = _run_both(tmp_path, saved['pointwise'], **kw)
    full = np.zeros((36, 36, 32, 2), dtype=np.float32)
    for idx, out in outputs.items():
        s_idx, t_idx = strategy.fwp_slicer.get_chunk_indices(idx)
        s_hr = strategy.fwp_slicer.s_hr_slices[s_idx]
        t_lr = strategy.fwp_slicer.t_lr_slices[t_idx]
        full[s_hr[0], s_hr[1], t_lr.start * 4:t_lr.stop * 4] = out
    one = ForwardPass.run(ForwardPassStrategy(**{
        **kw, 'model_kwargs': {'model_dir': saved['pointwise'],
                               'device': 'cpu'},
        'fwp_chunk_shape': (12, 12, 8), 'spatial_pad': 0,
        'temporal_pad': 0}), 0)[0]
    np.testing.assert_allclose(full, one, atol=1e-5)


@pytest.mark.parametrize('case', [
    # test_fwp_nc_output_shape_and_stitching
    dict(fwp_chunk_shape=(6, 6, 4), spatial_pad=2, temporal_pad=2),
    # test_device_batched_matches_serial, batched side
    dict(fwp_chunk_shape=(6, 6, 4), spatial_pad=1, temporal_pad=1,
         device_batch_size=4),
    # test_strategy_reference_compat_kwargs, a partial last batch
    dict(fwp_chunk_shape=(6, 6, 4), spatial_pad=1, temporal_pad=1,
         min_width=(5, 5, 3), use_cpu=True, device_batch_size=3),
], ids=['serial', 'batched', 'compat_kwargs'])
def test_arrays_match_jax(tmp_path, saved, case):
    _run_both(tmp_path, saved['st'], file_paths=_nc_input(tmp_path),
              out_pattern=None, **case)


def test_batched_matches_serial(tmp_path, saved):
    """test_device_batched_matches_serial on the port alone."""
    kw = dict(file_paths=_nc_input(tmp_path),
              model_kwargs={'model_dir': saved['st'], 'device': 'cpu'},
              fwp_chunk_shape=(6, 6, 4), spatial_pad=1, temporal_pad=1,
              out_pattern=None)
    serial = ForwardPass.run(ForwardPassStrategy(**kw), 0)
    batched = ForwardPass.run(
        ForwardPassStrategy(**kw, device_batch_size=4), 0)
    assert set(serial) == set(batched)
    for idx in serial:
        np.testing.assert_allclose(batched[idx], serial[idx], atol=1e-4)


def test_spatial_model_matches_jax(tmp_path, saved):
    """test_fwp_spatial_model: time steps become the batch dimension."""
    _, out = _run_both(
        tmp_path, saved['spatial'],
        file_paths=_nc_input(tmp_path, (10, 10, 5)),
        fwp_chunk_shape=(5, 5, 5), spatial_pad=1, temporal_pad=0,
        out_pattern=None, device_batch_size=2)
    assert out[0].shape == (10, 10, 5, 2)


@pytest.mark.parametrize('batch,pack', [(1, None), (4, None), (4, False)],
                         ids=['serial_packed', 'batched_packed',
                              'batched_host'])
def test_h5_output_matches_jax(tmp_path, saved, batch, pack):
    """test_fwp_h5_output_files_and_incremental: H5 input (u/v derived
    from windspeed/winddirection) to H5 output, through the device
    pack or the host transform."""
    input_file = make_fake_h5_file(
        str(tmp_path / 'wtk.h5'), (12, 12, 8),
        ['windspeed_100m', 'winddirection_100m'])
    strategy, _ = _run_both(
        tmp_path, saved['st'], suffix='h5', file_paths=input_file,
        fwp_chunk_shape=(6, 6, 4), spatial_pad=1, temporal_pad=1,
        device_batch_size=batch, pack_output_on_device=pack)
    assert len(glob.glob(str(tmp_path / 'port' / '*.h5'))) == 8
    assert strategy.node_finished(0)


def test_nc_output_matches_jax(tmp_path, saved):
    _run_both(tmp_path, saved['st'], suffix='nc',
              file_paths=_nc_input(tmp_path), fwp_chunk_shape=(6, 6, 4),
              spatial_pad=1, temporal_pad=1, device_batch_size=4)


def test_multi_node_and_raw_uv_match_jax(tmp_path, saved):
    """test_fwp_multi_node_split with test_fwp_invert_uv_option's raw
    (signed) u/v storage."""
    _run_both(tmp_path, saved['st'], nodes=(0, 1, 2), suffix='h5',
              file_paths=_nc_input(tmp_path), fwp_chunk_shape=(6, 6, 4),
              spatial_pad=1, temporal_pad=1, max_nodes=3, invert_uv=False)
    assert len(glob.glob(str(tmp_path / 'port' / '*.h5'))) == 8


@pytest.mark.parametrize('pack', [None, False])
def test_boundary_chunks_match_jax(tmp_path, saved, pack):
    """test_boundary_chunk_fwp_writes_complete_grid: the min-width
    adjusted final chunks, through both drains."""
    _run_both(tmp_path, saved['boundary'], suffix='h5',
              file_paths=_nc_input(tmp_path), fwp_chunk_shape=(8, 8, 4),
              spatial_pad=1, temporal_pad=1, pack_output_on_device=pack)


def test_spatial_mask_matches_jax(tmp_path, saved):
    """test_fwp_spatial_mask_skips_chunks: masked chunks are skipped."""
    input_file = _nc_input(tmp_path, (12, 12, 4), ('u100', 'v100', 'mask'))
    with netcdf_file(input_file, 'a', mmap=False) as f:
        arr = np.zeros(f.variables['mask'].shape, dtype=np.float32)
        arr[:, :6, :] = 1
        f.variables['mask'][:] = arr
    strategy, out = _run_both(
        tmp_path, saved['st'], file_paths=input_file,
        fwp_chunk_shape=(6, 6, 4), spatial_pad=0, temporal_pad=0,
        out_pattern=None)
    assert len(strategy.unmasked_chunks) == len(out) == 2


def test_nan_input_and_constant_output_raise(tmp_path, saved):
    strategy = ForwardPassStrategy(
        file_paths=_nc_input(tmp_path, (8, 8, 4)),
        model_kwargs={'model_dir': saved['st'], 'device': 'cpu'},
        fwp_chunk_shape=(8, 8, 4), out_pattern=None)
    fwp = ForwardPass(strategy, 0)
    chunk = fwp.get_input_chunk(0)
    chunk.input_data[0, 0, 0, 0] = np.nan
    with pytest.raises(RuntimeError, match='NaN'):
        fwp.run_chunk(chunk)
    with pytest.raises(MemoryError, match='constant'):
        ForwardPass._output_check(np.zeros((4, 4, 4, 1)))
    ForwardPass._output_check(np.zeros((4, 4, 4, 1)), allowed_const=[0.0])


@pytest.mark.parametrize('kwargs,match', [
    ({'input_handler_kwargs': {'cache_kwargs': {
        'cache_pattern': 'cache_{feature}.h5'}}}, 'cachers.py'),
    ({'use_mesh': True}, 'item 9'),
])
def test_later_slices_raise(tmp_path, saved, kwargs, match, monkeypatch):
    """Options of later slices raise. Feature caching (cachers.py) has
    come with the production-pipeline slice: its case now checks that
    the strategy's handler writes the cache (relative to the working
    directory) and that a second strategy reads it back."""
    kw = dict(file_paths=_nc_input(tmp_path, (8, 8, 4)),
              model_kwargs={'model_dir': saved['st'], 'device': 'cpu'},
              fwp_chunk_shape=(8, 8, 4), out_pattern=None)
    if match == 'cachers.py':
        monkeypatch.chdir(tmp_path)
        first = ForwardPassStrategy(**{**kw, **kwargs})
        assert sorted(os.listdir(tmp_path)) == [
            'cache_u_100m.h5', 'cache_v_100m.h5', 'input.nc']
        second = ForwardPassStrategy(**{**kw, **kwargs})
        assert second.input_handler.rasterizer is None
        np.testing.assert_array_equal(second.input_handler.data.data,
                                      first.input_handler.data.data)
        return
    with pytest.raises(NotImplementedError, match=match):
        ForwardPassStrategy(**{**kw, **kwargs})


def _factor_file(path, shape, method):
    """A factor file on ``_nc_input``'s grid: spatially varying linear
    factors, or QDM params correcting u_100m by about -0.1 in one
    day-of-year window."""
    rng = np.random.default_rng(9)
    lat, lon = np.meshgrid(np.linspace(40.0, 39.0, shape[0]),
                           np.linspace(-105.5, -104.3, shape[1]),
                           indexing='ij')
    with h5py.File(path, 'w') as f:
        f.create_dataset('latitude', data=lat)
        f.create_dataset('longitude', data=lon)
        if method == 'local_linear_bc':
            f.create_dataset('u_100m_scalar', data=rng.uniform(
                0.8, 1.2, shape + (1,)).astype(np.float32))
            f.create_dataset('u_100m_adder', data=rng.normal(
                0, 0.1, shape + (1,)).astype(np.float32))
            return {'u_100m': {'bias_fp': path}}
        row = np.percentile(rng.random(3000), np.linspace(0, 100, 21))
        oh = np.broadcast_to(row, shape + (1, 21)).astype(np.float32)
        f.create_dataset('base_u_100m_params', data=oh)
        f.create_dataset('bias_u_100m_params', data=oh + 0.1)
        f.create_dataset('bias_fut_u_100m_params', data=oh + 0.1)
        f.attrs['cfg'] = json.dumps({'time_window_center': [182.5],
                                     'sampling': 'linear', 'log_base': 10})
    return {'u_100m': {'bias_fp': path, 'base_dset': 'u_100m',
                       'relative': False}}


@pytest.mark.parametrize('method', ['local_linear_bc', 'local_qdm_bc'])
def test_bias_correction_matches_jax(tmp_path, saved, method):
    """Bias correction, which the forward pass refused before the bias
    slice, runs and gives the JAX package's output on the same input
    and factor file."""
    kwargs = _factor_file(str(tmp_path / 'bc.h5'), (12, 12), method)
    strategy, out = _run_both(
        tmp_path, saved['st'], file_paths=_nc_input(tmp_path),
        fwp_chunk_shape=(6, 6, 4), spatial_pad=1, temporal_pad=1,
        out_pattern=None, bias_correct_method=method,
        bias_correct_kwargs=kwargs)
    assert strategy.fwp_slicer.n_chunks == len(out) == 8


@pytest.mark.parametrize('kwargs', [
    {'chunked_io': True},
    {'input_handler_name': 'DataHandlerNCforCCwithPowerLaw'},
    {'input_handler_name': 'DataHandlerNCforCC'},
], ids=['chunked_io', 'power_law', 'nc_for_cc'])
def test_options_of_the_streaming_slice_run(tmp_path, saved, kwargs):
    """The options the forward pass refused before the streaming slice
    now run and give the JAX package's output on the same input (the
    GCM handlers read u_100m / v_100m straight from the file here; their
    own derivations are held in tests/test_torch_nc_cc.py)."""
    strategy, out = _run_both(tmp_path, saved['st'],
                              file_paths=_nc_input(tmp_path, (8, 8, 4)),
                              fwp_chunk_shape=(4, 4, 4), spatial_pad=1,
                              temporal_pad=1, out_pattern=None, **kwargs)
    assert strategy.fwp_slicer.n_chunks == len(out) == 4


def test_lazy_data_handler_raises(tmp_path):
    """``mode='lazy'`` gives the eager handler's data (windows derived
    on demand, bit-exact) and the JAX package's; the options it cannot
    window still raise."""
    path = _nc_input(tmp_path, (8, 8, 4))
    lazy = DataHandler(path, mode='lazy')
    eager = DataHandler(path)
    jax = JaxDataHandler(path, mode='lazy')
    idx = (slice(1, 7), slice(0, 5), slice(0, 4), lazy.features)
    np.testing.assert_array_equal(lazy.data.sample(idx),
                                  eager.data.sample(idx))
    np.testing.assert_array_equal(lazy.data.sample(idx),
                                  jax.data.sample(idx))
    with pytest.raises(NotImplementedError, match='time_roll'):
        DataHandler(path, mode='lazy', time_roll=1)


def test_auto_batch_on_the_cpu_needs_a_budget(tmp_path, saved):
    strategy = ForwardPassStrategy(
        file_paths=_nc_input(tmp_path, (8, 8, 4)),
        model_kwargs={'model_dir': saved['st'], 'device': 'cpu'},
        fwp_chunk_shape=(8, 8, 4), out_pattern=None,
        device_batch_size='auto')
    with pytest.raises(ValueError, match='hbm_bytes'):
        ForwardPass(strategy, 0)


def test_model_defaults_to_the_card(tmp_path, saved, monkeypatch):
    """Without ``device`` in model_kwargs the strategy loads the model
    onto the card, and raises when there is none."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ForwardPassStrategy(
            file_paths=_nc_input(tmp_path, (8, 8, 4)),
            model_kwargs={'model_dir': saved['st']},
            fwp_chunk_shape=(8, 8, 4), out_pattern=None)
