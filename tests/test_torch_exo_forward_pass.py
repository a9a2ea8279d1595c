"""The slice as a whole: the port's chunked ``ForwardPass`` with
exogenous data and model chains against the JAX package's, on the
fixtures of tests/forward_pass/test_multistep_exo_fwp.py,
test_exo_chains.py and test_batched_fwp.py — the same input files, the
same topography source and the same weights (JAX save directories read
by the port's ``load``). Outputs agree within 1e-4 of their largest
magnitude. Chunks with exo run through the device-batched path for a 5D
``Sup3rGan`` and equal the chunk-by-chunk run; output-combine exo, 4D
models and chains run chunk by chunk."""

import os
import warnings

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from sup3r_tpu.models import LinearInterp as JaxLinear
from sup3r_tpu.models import Sup3rGan as JaxGan
from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
from sup3r_tpu.utilities.test_helpers import (
    make_fake_h5_file,
    make_fake_nc_file,
)
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.utilities.test_helpers import make_fake_topo_nc_file
from tests.forward_pass import test_exo_chains as chains
from tests.forward_pass import test_multistep_exo_fwp as multistep

torch.set_num_threads(1)

RTOL = 1e-4
FEATURES = ['u_100m', 'v_100m']


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = RTOL * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol, (what, err, tol)


def _strategies(tmp_path, model_kwargs, exo, **kwargs):
    """(port strategy, JAX strategy) on the same kwargs; each package
    rasterizes into its own exo cache."""
    out = []
    for name, Strategy, device in (('port', ForwardPassStrategy, 'cpu'),
                                   ('jax', JaxStrategy, None)):
        exo_kw = {f: {**v, 'cache_dir': str(tmp_path / f'exo_{name}')}
                  for f, v in exo.items()}
        mkw = dict(model_kwargs, **({'device': device} if device else {}))
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            out.append(Strategy(model_kwargs=mkw, exo_handler_kwargs=exo_kw,
                                **kwargs))
    return out


def _run_both(tmp_path, model_kwargs, exo, **kwargs):
    """Both packages' ``ForwardPass.run`` on the same kwargs; the exo
    steps and every chunk's output must agree. Returns the port's
    strategy and outputs."""
    port_s, jax_s = _strategies(tmp_path, model_kwargs, exo, **kwargs)
    for feat in jax_s.exo_data:
        steps = port_s.exo_data[feat]['steps']
        want = jax_s.exo_data[feat]['steps']
        assert [{k: v for k, v in s.items() if k != 'data'}
                for s in steps] == [{k: v for k, v in s.items()
                                     if k != 'data'} for s in want]
        for s, w in zip(steps, want):
            np.testing.assert_allclose(s['data'], w['data'], rtol=1e-6)
    assert port_s.input_features == jax_s.input_features
    port = ForwardPass.run(port_s, 0)
    jax_out = JaxForwardPass.run(jax_s, 0)
    assert sorted(port) == sorted(jax_out) and port
    for idx in jax_out:
        _close(port[idx], jax_out[idx], idx)
    return port_s, port


@pytest.fixture
def inputs(tmp_path):
    return chains._input_and_topo(tmp_path)


def _topo(topo_file):
    return {'topography': {'source_file': topo_file}}


def test_multistep_fwp_with_exo_both_steps(tmp_path, inputs):
    """test_multistep_exo_fwp.py: a 2x-then-2x chain of 4D models, each
    taking topography as an input channel and in a Sup3rConcat layer."""
    m1 = multistep._gan_with_topo(tmp_path, 'm1', 2, False, FEATURES)
    m2 = multistep._gan_with_topo(tmp_path, 'm2', 2, False, FEATURES)
    strategy, out = _run_both(
        tmp_path, {'model_dirs': [m1, m2]}, _topo(inputs[1]),
        file_paths=inputs[0], model_class='MultiStepGan',
        fwp_chunk_shape=(4, 4, 4), spatial_pad=1, temporal_pad=0,
        out_pattern=None)
    enh = {(s['model'], s['combine_type']): s['s_enhance']
           for s in strategy.exo_data['topography']['steps']}
    assert enh == {(0, 'input'): 1, (0, 'layer'): 2, (1, 'input'): 2,
                   (1, 'layer'): 4}
    assert out[0].shape == (16, 16, 4, 2)


def test_multistep_exoskip(tmp_path, inputs):
    """test_exo_chains.py::test_multistep_exoskip: a spatial topography
    step then a temporal step without exo, with temporal padding."""
    m1 = chains._topo_spatial_gan(tmp_path, 'm1', FEATURES)
    m2 = chains._plain_temporal_gan(tmp_path, 'm2', FEATURES)
    _, out = _run_both(
        tmp_path, {'model_dirs': [m1, m2]}, _topo(inputs[1]),
        file_paths=inputs[0], model_class='MultiStepGan',
        fwp_chunk_shape=(8, 8, 2), spatial_pad=0, temporal_pad=1,
        out_pattern=None)
    assert out[0].shape == (16, 16, 8, 2)


def test_linear_then_topo_gan_chain(tmp_path, inputs):
    """test_exo_chains.py::test_linear_then_topo_gan_chain."""
    lin_dir = str(tmp_path / 'lin')
    JaxLinear(lr_features=FEATURES, s_enhance=2, t_enhance=1).save(lin_dir)
    gan = chains._topo_spatial_gan(tmp_path, 'gan', FEATURES)
    strategy, out = _run_both(
        tmp_path, {'model_dirs': [lin_dir, gan]}, _topo(inputs[1]),
        file_paths=inputs[0], model_class='MultiStepGan',
        fwp_chunk_shape=(8, 8, 4), spatial_pad=0, temporal_pad=0,
        out_pattern=None)
    steps = strategy.exo_data['topography']['steps']
    assert {s['combine_type']: s['s_enhance'] for s in steps} == {
        'input': 2, 'layer': 4}
    assert out[0].shape == (32, 32, 4, 2)


def test_multi_exo_topo_and_sza(tmp_path, inputs):
    """test_exo_chains.py::test_multi_exo_topo_and_sza: one 4D model
    with topography and sza as input channels and layers, padded chunks
    written to NetCDF by both packages."""
    gen = [
        {'class': 'Conv2D', 'filters': 32, 'kernel_size': 3, 'strides': 1,
         'padding': 'same'},
        {'class': 'SpatialExpansion', 'spatial_mult': 2},
        {'class': 'LeakyReLU', 'alpha': 0.2},
        {'class': 'Sup3rConcat', 'name': 'topography'},
        {'class': 'Conv2D', 'filters': 8, 'kernel_size': 3, 'strides': 1,
         'padding': 'same'},
        {'class': 'Sup3rConcat', 'name': 'sza'},
        {'class': 'Conv2D', 'filters': 2, 'kernel_size': 3, 'strides': 1,
         'padding': 'same'}]
    model = JaxGan(gen, [{'class': 'Flatten'},
                         {'class': 'Dense', 'units': 1}])
    feats = [*FEATURES, 'topography', 'sza']
    model.meta.update(lr_features=feats, hr_out_features=FEATURES,
                      s_enhance=2, t_enhance=1,
                      input_resolution={'spatial': '12km',
                                        'temporal': '60min'})
    model.set_norm_stats({f: 0.1 * i for i, f in enumerate(feats)},
                         {f: 1.0 + i for i, f in enumerate(feats)})
    model.init_weights((1, 4, 4, 4), (1, 8, 8, 2))
    model_dir = str(tmp_path / 'multi_exo')
    model.save(model_dir)
    runs = zip(_strategies(tmp_path, {'model_dir': model_dir},
                           {'topography': {'source_file': inputs[1]},
                            'sza': {}},
                           file_paths=inputs[0], fwp_chunk_shape=(4, 8, 2),
                           spatial_pad=1, temporal_pad=1, out_pattern=None),
               ('port', 'jax'), (ForwardPass, JaxForwardPass))
    for strategy, name, Fwp in runs:
        strategy.out_pattern = str(tmp_path / name / 'c_{file_id}.nc')
        strategy._out_files = None
        Fwp.run(strategy, 0)
    files = sorted(os.listdir(tmp_path / 'jax'))
    assert sorted(os.listdir(tmp_path / 'port')) == files
    assert len(files) == 4
    for f in files:
        with netcdf_file(str(tmp_path / 'port' / f), 'r',
                         mmap=False) as fp, \
                netcdf_file(str(tmp_path / 'jax' / f), 'r',
                            mmap=False) as fj:
            for var in FEATURES:
                _close(fp.variables[var].data, fj.variables[var].data,
                       (f, var))


def _st_topo_model(tmp_path, out_features=FEATURES, norm=True):
    """test_batched_fwp.py::test_exo_chunks_are_batched's 5D generator
    (a Sup3rConcat topography layer after the expansion), saved by the
    JAX package; with ``out_features`` holding topography it becomes an
    output-combine model."""
    gen = [{'class': 'Conv3D', 'filters': 8, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'},
           {'class': 'SpatioTemporalExpansion', 'spatial_mult': 2},
           {'class': 'Sup3rConcat', 'name': 'topography'},
           {'class': 'Conv3D', 'filters': 2, 'kernel_size': 3,
            'strides': 1, 'padding': 'same'}]
    if 'topography' in out_features:
        gen = [gen[0], gen[1], gen[3]]
    disc = [{'class': 'Flatten'}, {'class': 'Dense', 'units': 1}]
    model = JaxGan(gen, disc)
    model.meta.update(lr_features=FEATURES,
                      hr_out_features=list(out_features),
                      s_enhance=2, t_enhance=1,
                      input_resolution={'spatial': '12km',
                                        'temporal': '60min'})
    if norm:
        model.set_norm_stats({f: 0.1 for f in FEATURES + ['topography']},
                             {f: 0.9 for f in FEATURES + ['topography']})
    model.init_weights((1, 6, 6, 4, 2), (1, 12, 12, 4, 3))
    model_dir = str(tmp_path / 'model')
    model.save(model_dir)
    return model_dir


@pytest.fixture
def batched_inputs(tmp_path):
    input_file = make_fake_nc_file(str(tmp_path / 'in.nc'), (12, 12, 4),
                                   ['u100', 'v100'])
    topo_file = make_fake_h5_file(str(tmp_path / 'topo.h5'), (24, 24, 2),
                                  ['topography'])
    return input_file, topo_file


def _counting(monkeypatch):
    """Count per-chunk runs and batched dispatches of the port."""
    calls = {'run_chunk': 0, 'dispatched': 0}
    run_chunk, dispatch = ForwardPass.run_chunk, \
        ForwardPass._dispatch_chunk_batch

    def counted_run_chunk(self, *a, **k):
        calls['run_chunk'] += 1
        return run_chunk(self, *a, **k)

    def counted_dispatch(self, batch):
        out = dispatch(self, batch)
        calls['dispatched'] += out is not None
        return out

    monkeypatch.setattr(ForwardPass, 'run_chunk', counted_run_chunk)
    monkeypatch.setattr(ForwardPass, '_dispatch_chunk_batch',
                        counted_dispatch)
    return calls


def test_exo_chunks_are_batched(tmp_path, batched_inputs, monkeypatch):
    """test_batched_fwp.py::test_exo_chunks_are_batched: chunks with
    topography go through the device-batched path (a partial last batch
    included), equal the chunk-by-chunk run and the JAX package's."""
    model_dir = _st_topo_model(tmp_path)
    kw = dict(file_paths=batched_inputs[0], fwp_chunk_shape=(4, 6, 4),
              spatial_pad=1, temporal_pad=0, out_pattern=None)
    topo = {'topography': {'source_file': batched_inputs[1]}}
    _, serial = _run_both(tmp_path / 'serial', {'model_dir': model_dir},
                          topo, device_batch_size=1, **kw)
    calls = _counting(monkeypatch)
    port, _ = _strategies(tmp_path / 'batched', {'model_dir': model_dir},
                          topo, device_batch_size=4, **kw)
    batched = ForwardPass.run(port, 0)
    assert calls == {'run_chunk': 0, 'dispatched': 2}
    assert sorted(batched) == sorted(serial) == list(range(6))
    for idx in serial:
        _close(batched[idx], serial[idx], idx)


def test_output_combine_exo_runs_chunk_by_chunk(tmp_path, batched_inputs,
                                                monkeypatch):
    """A 5D model whose outputs end with topography (output-combine exo,
    concatenated on the host after the fetch) falls back from the
    batched path to chunk-by-chunk runs, as in the JAX package."""
    model_dir = _st_topo_model(tmp_path, [*FEATURES, 'topography'],
                               norm=False)
    calls = _counting(monkeypatch)
    strategy, out = _run_both(
        tmp_path, {'model_dir': model_dir},
        {'topography': {'source_file': batched_inputs[1]}},
        file_paths=batched_inputs[0], fwp_chunk_shape=(6, 6, 4),
        spatial_pad=1, temporal_pad=0, out_pattern=None,
        device_batch_size=4)
    assert [s['combine_type'] for s in
            strategy.exo_data['topography']['steps']] == ['output']
    assert calls == {'run_chunk': 4, 'dispatched': 0}
    assert out[0].shape == (12, 12, 4, 3)
    want = strategy.exo_data['topography']['steps'][0]['data'][:12, :12]
    np.testing.assert_array_equal(out[0][..., 2], np.repeat(want, 4, -1))


def test_netcdf_topography_source(tmp_path, batched_inputs, monkeypatch):
    """A NetCDF3 topography source (no h5py) through the batched path,
    the exo cache defaulting under the output directory."""
    monkeypatch.delenv('SUP3R_TPU_EXO_CACHE_DIR')
    model_dir = _st_topo_model(tmp_path)
    topo = make_fake_topo_nc_file(str(tmp_path / 'topo.nc'), (30, 30),
                                  lat_range=(40.2, 38.8),
                                  lon_range=(-105.7, -104.1))
    out_dir = tmp_path / 'out'
    strategy = ForwardPassStrategy(
        file_paths=batched_inputs[0],
        model_kwargs={'model_dir': model_dir, 'device': 'cpu'},
        fwp_chunk_shape=(6, 6, 4), spatial_pad=1, temporal_pad=0,
        exo_handler_kwargs={'topography': {'source_file': topo}},
        out_pattern=str(out_dir / 'c_{file_id}.nc'), device_batch_size=4)
    ForwardPass.run(strategy, 0)
    assert sorted(os.listdir(out_dir)) == [
        'c_000000_000000.nc', 'c_000000_000001.nc', 'c_000000_000002.nc',
        'c_000000_000003.nc', 'exo_cache']
    cache = os.listdir(out_dir / 'exo_cache')
    assert len(cache) == 1 and cache[0].startswith('exo_topography_')
