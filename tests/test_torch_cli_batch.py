"""The port's ``pipeline`` failures and ``batch`` command on the CPU
through real node processes: the cases of
tests/pipeline/test_pipeline_failures.py (a failing step, resume after
a fix, batch permutations, an edited config) and test_cli.py's batch
cases, ported."""

import json
import os

import h5py
import pytest

from sup3r_tpu_torch.cli import main
from sup3r_tpu_torch.utilities.cli import Status
from tests.test_torch_cli import fwp_setup, node_env, write_json  # noqa
from tests.test_torch_cli_pipeline import (
    _collect_cfg,
    _pipeline,
    _step_keys,
)


@pytest.fixture
def project(fwp_setup):
    """One chunk per forward pass (10 x 10 x 4), as the JAX failure
    tests set it up."""
    tmp_path, fwp_fp, out_pattern = fwp_setup
    cfg = dict(json.load(open(fwp_fp)), fwp_chunk_shape=[10, 10, 4],
               spatial_pad=0)
    return tmp_path, cfg, out_pattern


def test_failing_step_blocks_then_resumes_after_fix(project):
    """A bad model directory fails the forward-pass step during setup:
    the status records it and the collect step never runs. After the
    config is fixed, a rerun resumes and completes both steps."""
    tmp_path, cfg, out_pattern = project
    bad = dict(cfg, model_kwargs={
        'model_dir': str(tmp_path / 'nonexistent_model'), 'device': 'cpu'})
    write_json(tmp_path / 'config_fwp.json', bad)
    out_file = str(tmp_path / 'collected.h5')
    _collect_cfg(tmp_path, out_pattern, out_file)
    pipe_fp = _pipeline(tmp_path, {'forward-pass': 'config_fwp.json'},
                        {'data-collect': 'config_collect.json'})
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 1
    assert not os.path.exists(out_file)
    status = Status(str(tmp_path)).read()
    keys = _step_keys(status, 'forward-pass')
    assert keys and any(j['job_status'] == 'failed'
                        for k in keys for j in status[k].values())
    write_json(tmp_path / 'config_fwp.json', cfg)
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    assert os.path.exists(out_file)
    st = Status(str(tmp_path))
    data = st.read()
    assert any(st.module_successful(k)
               for k in _step_keys(data, 'forward-pass'))
    assert any(st.module_successful(k)
               for k in _step_keys(data, 'data-collect'))


def test_failing_node_fails_step(project):
    """A node that raises (an unknown bias correction method, which the
    head's planning pass does not check) marks its job failed with its
    traceback, and the pipeline exits 1."""
    tmp_path, cfg, _ = project
    write_json(tmp_path / 'config_fwp.json', dict(
        cfg, bias_correct_method='no_such_method',
        bias_correct_kwargs={'u_100m': {}}))
    pipe_fp = _pipeline(tmp_path, {'forward-pass': 'config_fwp.json'})
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 1
    status = Status(str(tmp_path)).read()
    key = _step_keys(status, 'forward-pass')[0]
    nodes = [j for k, j in status[key].items() if not k.endswith('_setup')]
    assert len(nodes) == 1 and nodes[0]['job_status'] == 'failed'
    assert 'no_such_method' in nodes[0]['stderr']
    # as in the JAX package, the step's own failure is recorded too
    assert status[key][key + '_setup']['job_status'] == 'failed'


def test_batch_dry_run_cancel_and_delete(tmp_path):
    write_json(tmp_path / 'config_fwp.json',
               {'spatial_pad': 0, 'temporal_pad': 0})
    batch_fp = write_json(tmp_path / 'config_batch.json', {'sets': [{
        'args': {'spatial_pad': [1, 2], 'temporal_pad': [0, 1]},
        'files': ['config_fwp.json']}]})
    assert main(['-c', batch_fp, 'batch', '--dry-run']) == 0
    dirs = sorted(p.name for p in tmp_path.glob('batch_*'))
    assert dirs == ['batch_spatial_pad_1_temporal_pad_0',
                    'batch_spatial_pad_1_temporal_pad_1',
                    'batch_spatial_pad_2_temporal_pad_0',
                    'batch_spatial_pad_2_temporal_pad_1']
    cfg = json.load(open(tmp_path / dirs[3] / 'config_fwp.json'))
    assert cfg == {'spatial_pad': 2, 'temporal_pad': 1}
    assert main(['-c', batch_fp, 'batch', '--cancel']) == 0
    assert main(['-c', batch_fp, 'batch', '--delete']) == 0
    assert not list(tmp_path.glob('batch_*'))


def test_batch_runs_permutation_projects(project):
    """batch expands the permutations into project directories and runs
    each pipeline; keys a config lacks are not added to it."""
    tmp_path, cfg, _ = project
    write_json(tmp_path / 'config_fwp.json',
               dict(cfg, out_pattern='./out/chunk_{file_id}.h5'))
    write_json(tmp_path / 'config_collect.json', {
        'file_paths': './out/chunk_*.h5', 'out_file': './collected.h5',
        'execution_control': {'option': 'local'}})
    _pipeline(tmp_path, {'forward-pass': 'config_fwp.json'},
              {'data-collect': 'config_collect.json'})
    batch_fp = write_json(tmp_path / 'config_batch.json', {'sets': [{
        'args': {'spatial_pad': [0, 1]},
        'files': ['config_fwp.json', 'config_collect.json',
                  'config_pipeline.json']}]})
    assert main(['-c', batch_fp, 'batch']) == 0
    dirs = sorted(p for p in tmp_path.iterdir()
                  if p.name.startswith('batch_'))
    assert len(dirs) == 2
    for pad, d in enumerate(dirs):
        assert json.load(open(d / 'config_fwp.json'))['spatial_pad'] == pad
        assert 'spatial_pad' not in json.load(
            open(d / 'config_collect.json'))
        with h5py.File(d / 'collected.h5', 'r') as f:
            assert f['windspeed_100m'].shape == (4, 400)


def test_edited_config_reruns_step(project):
    """Changing a step's config changes its identity, so it reruns; an
    unchanged config is skipped."""
    tmp_path, cfg, _ = project
    write_json(tmp_path / 'config_fwp.json', cfg)
    pipe_fp = _pipeline(tmp_path, {'forward-pass': 'config_fwp.json'})
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    assert len(list((tmp_path / 'out').glob('*.h5'))) == 1
    write_json(tmp_path / 'config_fwp.json', dict(
        cfg, out_pattern=str(tmp_path / 'out2' / 'c_{file_id}.h5')))
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    files = list((tmp_path / 'out2').glob('*.h5'))
    assert files
    mtimes = {f: f.stat().st_mtime for f in files}
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    for f, t in mtimes.items():
        assert f.stat().st_mtime == t
    assert len(_step_keys(Status(str(tmp_path)).read(),
                          'forward-pass')) == 2
