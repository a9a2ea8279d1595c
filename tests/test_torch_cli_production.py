"""The port's production pipeline on the CPU through real node
processes, held to the JAX package:

- the pipeline's collected NetCDF output and QA errors against the JAX
  package's in-process ``ForwardPass.run`` + ``CollectorNC.collect`` +
  ``Sup3rQa.run`` on the same weights (a JAX save the port loads through
  ``models/weights.py``), at rtol 1e-4;
- the one-config production rehearsal of
  tests/pipeline/test_production_rehearsal.py (forward-pass ->
  data-collect -> solar -> qa, the named-step spelling included);
- the chunked ``DataHandlerNCforCC`` head shipping its clearsky scale
  raster to the nodes (tests/forward_pass/test_fwp_input_handlers.py
  ``test_cli_chunked_nc_cc_ships_clearsky_scale``).

The JAX package's CLI cannot run these here: its nodes cannot import
``sup3r_tpu``."""

import glob
import json
import os

import h5py
import numpy as np
import pytest

from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
from sup3r_tpu.postprocessing.collectors import CollectorNC as JaxCollectorNC
from sup3r_tpu.qa import Sup3rQa as JaxQa
from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
from sup3r_tpu_torch.cli import main
from sup3r_tpu_torch.preprocessing.loaders import LoaderNC
from sup3r_tpu_torch.utilities.cli import Status
from tests.forward_pass.test_forward_pass import _save_model, _st_gen_config
from tests.forward_pass.test_fwp_input_handlers import _csr_model
from tests.pipeline.test_production_rehearsal import (
    N_DAYS,
    S_ENHANCE,
    T_ENHANCE,
    rehearsal,  # noqa: F401
)
from tests.solar_qa.test_solar_qa import _make_fake_nsrdb
from tests.test_torch_cli import node_env, write_json  # noqa: F401

RTOL = 1e-4


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    tol = RTOL * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err, tol)


def test_pipeline_matches_jax_in_process(tmp_path):
    """A spatiotemporal 3x / 4x model over a (12, 12, 8) u / v input in
    chunks of (6, 6, 4) on two nodes, collected to NetCDF and QA'd
    (ws / wd from the source's u / v), equals the JAX package's modules
    run in-process on the same files and weights."""
    input_file = make_fake_nc_file(str(tmp_path / 'input.nc'), (12, 12, 8),
                                   ['u100', 'v100'])
    model_dir, _ = _save_model(str(tmp_path / 'model'), _st_gen_config(),
                               3, 4)
    common = dict(file_paths=input_file, fwp_chunk_shape=[6, 6, 4],
                  spatial_pad=1, temporal_pad=1, max_nodes=2,
                  device_batch_size=2)
    out_pattern = str(tmp_path / 'port' / 'chunk_{file_id}.nc')
    collected = str(tmp_path / 'collected.nc')
    qa_fp = str(tmp_path / 'qa.h5')
    qa_kw = dict(source_file_paths=input_file, s_enhance=3, t_enhance=4,
                 temporal_coarsening_method='average',
                 features=['u_100m', 'v_100m'])
    write_json(tmp_path / 'config_fwp.json', dict(
        common, model_kwargs={'model_dir': model_dir, 'device': 'cpu'},
        out_pattern=out_pattern, execution_control={'option': 'local'}))
    write_json(tmp_path / 'config_collect.json', {
        'file_paths': out_pattern.replace('{file_id}', '*'),
        'out_file': collected, 'max_workers': 1})
    write_json(tmp_path / 'config_qa.json', dict(
        qa_kw, out_file_path=collected, qa_fp=qa_fp, device='cpu'))
    pipe_fp = write_json(tmp_path / 'config_pipeline.json', {'pipeline': [
        {'forward-pass': 'config_fwp.json'},
        {'data-collect': 'config_collect.json'},
        {'qa': 'config_qa.json'}]})
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    assert len(glob.glob(out_pattern.replace('{file_id}', '*'))) == 8
    status = Status(str(tmp_path)).read()
    assert all(j['job_status'] == 'successful'
               for k, jobs in status.items() if not k.startswith('__')
               for j in jobs.values())

    jax_pattern = str(tmp_path / 'jax' / 'chunk_{file_id}.nc')
    strategy = JaxStrategy(model_kwargs={'model_dir': model_dir},
                           out_pattern=jax_pattern, **common)
    for node in range(len(strategy.node_chunks)):
        JaxForwardPass.run(strategy, node)
    jax_collected = str(tmp_path / 'jax_collected.nc')
    JaxCollectorNC.collect(jax_pattern.replace('{file_id}', '*'),
                           jax_collected)
    port, jax = LoaderNC(collected).data, LoaderNC(jax_collected).data
    np.testing.assert_array_equal(port.lat_lon, jax.lat_lon)
    assert port.time_index.equals(jax.time_index)
    assert port.shape == jax.shape == (36, 36, 32, 2)
    for f in ('u_100m', 'v_100m'):
        _close(port[f], jax[f], f)
    want = JaxQa(out_file_path=jax_collected, **qa_kw).run()
    with h5py.File(qa_fp) as f:
        for k, v in want.items():
            _close(f[k][:], v, k)


def test_production_rehearsal(rehearsal):  # noqa: F811
    """forward-pass -> data-collect -> solar -> qa from one pipeline
    config (the solar step in the named spelling), on the CPU."""
    tmp_path, input_file, nsrdb_fp, collected, qa_fp = rehearsal
    for name, key in (('config_fwp.json', 'model_kwargs'),
                      ('config_qa.json', None)):
        cfg = json.load(open(tmp_path / name))
        if key:
            cfg[key]['device'] = 'cpu'
        else:
            cfg['device'] = 'cpu'
        write_json(tmp_path / name, cfg)
    pipe_fp = str(tmp_path / 'config_pipeline.json')
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0

    hr_sites = (10 * S_ENHANCE) ** 2
    chunks = [p for p in sorted((tmp_path / 'out').glob('sup3r_chunk_*.h5'))
              if 'irradiance' not in p.name]
    assert len(chunks) == N_DAYS
    with h5py.File(collected, 'r') as f:
        assert f['clearsky_ratio'].shape == (N_DAYS * T_ENHANCE, hr_sites)
        assert np.isfinite(f['clearsky_ratio'][...]).all()
    irr = sorted((tmp_path / 'out').glob('*_irradiance.h5'))
    assert len(irr) == N_DAYS
    for fp in irr:
        with h5py.File(fp, 'r') as f:
            for dset in ('ghi', 'dni', 'dhi'):
                arr = f[dset][...] / f[dset].attrs['scale_factor']
                assert arr.shape == (T_ENHANCE, hr_sites)
                assert np.isfinite(arr).all() and (arr >= 0).all()
                assert arr.max() < 1400
            assert f['ghi'][...].max() > 0
    with h5py.File(qa_fp, 'r') as f:
        err = f['clearsky_ratio_error'][...]
        assert err.shape[-1] == N_DAYS and np.isfinite(err).all()
        assert 'clearsky_ratio_synthetic' in f and 'clearsky_ratio_true' in f
    status = Status(str(tmp_path))
    keys = [k for k in status.read() if not k.startswith('__')]
    assert sorted(k.split('#')[0] for k in keys) == [
        'data-collect', 'forward-pass', 'qa', 'solar']
    assert all(status.module_successful(k) for k in keys)
    before = json.dumps(status.read(), sort_keys=True)
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    assert json.dumps(status.read(), sort_keys=True) == before


def test_cli_chunked_nc_cc_ships_clearsky_scale(tmp_path):
    """chunked_io x DataHandlerNCforCC: the head computes the per-pixel
    clearsky scale once and ships it to the nodes as an .npy side file;
    the chunk equals the port's in-process eager pass."""
    from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy

    gcm_fp = make_fake_nc_file(str(tmp_path / 'gcm.nc'), (8, 8, 4),
                               ['rsds'], freq='D')
    nsrdb_fp = _make_fake_nsrdb(str(tmp_path / 'nsrdb.h5'), (12, 12, 96),
                                start='2023-01-01')
    kw = dict(file_paths=gcm_fp,
              model_kwargs={'model_dir': _csr_model(tmp_path),
                            'device': 'cpu'},
              model_class='Sup3rGan',
              input_handler_name='DataHandlerNCforCC',
              input_handler_kwargs={'nsrdb_source_fp': nsrdb_fp},
              fwp_chunk_shape=[8, 8, 4], spatial_pad=0, temporal_pad=0)
    out_pattern = str(tmp_path / 'out' / 'chunk_{file_id}.h5')
    fp = write_json(tmp_path / 'config_fwp.json', dict(
        kw, chunked_io=True, out_pattern=out_pattern,
        execution_control={'option': 'local'}))
    assert main(['-c', fp, 'forward-pass']) == 0
    node_cfg = json.load(open(glob.glob(
        str(tmp_path / '.forward-pass*node0.json'))[0]))
    scale = node_cfg['input_handler_kwargs']['clearsky_scale']
    assert isinstance(scale, str) and scale.endswith('.npy')
    raster = np.load(scale)
    assert raster.shape == (8, 8) and (raster > 0).all()
    eager = ForwardPass.run(ForwardPassStrategy(out_pattern=None, **kw), 0)
    with h5py.File(out_pattern.format(file_id='000000_000000')) as f:
        got = f['clearsky_ratio'][...] / f['clearsky_ratio'].attrs[
            'scale_factor']
    want = next(iter(eager.values()))[..., 0]
    want = np.clip(want, 0, 1).reshape(-1, want.shape[-1]).T
    np.testing.assert_allclose(got, want, atol=1.5 / 100)


@pytest.mark.parametrize('ext', ['nc', 'h5'])
def test_collect_step_formats(tmp_path, ext):
    """A data-collect node picks the collector by the output extension."""
    from sup3r_tpu.postprocessing.writers import (
        OutputHandlerH5,
        OutputHandlerNC,
    )
    from tests.output.test_output_handling import _grid

    import pandas as pd

    rng = np.random.default_rng(0)
    data = rng.random((6, 6, 4, 1)).astype(np.float32)
    times = pd.date_range('2023-01-01', periods=4, freq='h')
    handler = OutputHandlerNC if ext == 'nc' else OutputHandlerH5
    feature = 'u_100m' if ext == 'nc' else 'windspeed_100m'
    for s_idx, ss in enumerate([slice(0, 3), slice(3, 6)]):
        kw = {} if ext == 'nc' else {
            'gids': np.arange(36).reshape(6, 6)[ss]}
        handler._write_output(data[ss].copy(), [feature], _grid(6, 6)[ss],
                              times, str(tmp_path / f'c_000000_{s_idx:06d}'
                                         f'.{ext}'), **kw)
    out = str(tmp_path / f'collected.{ext}')
    cfg = write_json(tmp_path / 'config_collect.json', {
        'file_paths': str(tmp_path / f'c_*.{ext}'), 'out_file': out})
    assert main(['-c', cfg, 'data-collect']) == 0
    assert os.path.exists(out)
