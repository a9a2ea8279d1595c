"""The port's ``pipeline`` command on the CPU through real node
processes: the cases of tests/pipeline/test_cli.py (monitor,
background, repeated module, the two forward-pass steps of
test_pipeline_failures.py, step configs in subdirectories), ported. The
JAX package's versions of these fail because its nodes cannot import
``sup3r_tpu``; the port's nodes import the port from any directory.
Failures, resumes and batches are in test_torch_cli_batch.py."""

import json
import os
import time

import h5py

from sup3r_tpu_torch.cli import main
from sup3r_tpu_torch.utilities.cli import Status
from tests.test_torch_cli import fwp_setup, node_env, write_json  # noqa


def _pipeline(tmp_path, *steps, name='config_pipeline.json'):
    return write_json(tmp_path / name, {'pipeline': list(steps)})


def _collect_cfg(tmp_path, out_pattern, out_file, name='config_collect.json'):
    return write_json(tmp_path / name, {
        'file_paths': out_pattern.replace('{file_id}', '*'),
        'out_file': out_file, 'execution_control': {'option': 'local'}})


def _step_keys(status, module):
    return [k for k in status if k.startswith(module + '#')]


def test_cli_pipeline_monitor(fwp_setup):
    """forward-pass then data-collect run to completion; a rerun starts
    no node and reports each step already successful."""
    tmp_path, _, out_pattern = fwp_setup
    out_file = str(tmp_path / 'collected.h5')
    _collect_cfg(tmp_path, out_pattern, out_file)
    pipe_fp = _pipeline(tmp_path, {'forward-pass': 'config_fwp.json'},
                        {'data-collect': 'config_collect.json'})
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    with h5py.File(out_file, 'r') as f:
        assert f['windspeed_100m'].shape == (4, 400)
    status = Status(str(tmp_path)).read()
    before = json.dumps(status, sort_keys=True)
    mtime = os.path.getmtime(out_file)
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    assert json.dumps(Status(str(tmp_path)).read(),
                      sort_keys=True) == before
    assert os.path.getmtime(out_file) == mtime


def test_pipeline_background(fwp_setup):
    """--background detaches a monitor process (no PYTHONPATH either)
    that completes the pipeline."""
    tmp_path, *_ = fwp_setup
    pipe_fp = _pipeline(tmp_path, {'forward-pass': 'config_fwp.json'})
    assert main(['-c', pipe_fp, 'pipeline', '--background']) == 0
    pid = int((tmp_path / '.pipeline_monitor.pid').read_text())
    deadline = time.time() + 180
    while time.time() < deadline:
        if len(list((tmp_path / 'out').glob('*.h5'))) == 4 and Status(
                str(tmp_path)).module_successful(next(iter(_step_keys(
                    Status(str(tmp_path)).read(), 'forward-pass')), '-')):
            break
        time.sleep(1)
    assert len(list((tmp_path / 'out').glob('*.h5'))) == 4
    # the detached monitor exits once its pipeline is done
    while time.time() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        try:
            if os.waitpid(pid, os.WNOHANG)[0] == pid:
                break
        except ChildProcessError:
            pass
        time.sleep(0.5)
    assert 'Running pipeline step' in (
        tmp_path / 'pipeline_monitor.log').read_text()


def test_cli_pipeline_repeated_module(fwp_setup):
    """Two forward-pass steps (different outputs) keep distinct step
    keys, and a rerun skips both."""
    tmp_path, fwp_fp, _ = fwp_setup
    cfg = json.load(open(fwp_fp))
    write_json(tmp_path / 'config_fwp2.json', dict(
        cfg, out_pattern=str(tmp_path / 'out2' / 'chunk_{file_id}.h5')))
    pipe_fp = _pipeline(tmp_path, {'forward-pass': 'config_fwp.json'},
                        {'forward-pass': 'config_fwp2.json'})
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    assert len(list((tmp_path / 'out').glob('*.h5'))) == 4
    assert len(list((tmp_path / 'out2').glob('*.h5'))) == 4
    status = Status(str(tmp_path)).read()
    keys = _step_keys(status, 'forward-pass')
    assert len(keys) == 2
    for k in keys:
        assert all(j['job_status'] == 'successful'
                   for j in status[k].values())
    mtimes = {p: p.stat().st_mtime for p in (tmp_path / 'out').glob('*')}
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    for p, m in mtimes.items():
        assert p.stat().st_mtime == m


def test_pipeline_step_configs_in_subdirs(fwp_setup):
    """Step configs in their own directories record node status there,
    and the monitor polls those stores; the named-step spelling
    (``{'name': cfg, 'command': module}``) works too."""
    tmp_path, fwp_fp, out_pattern = fwp_setup
    (tmp_path / 'fwp').mkdir()
    write_json(tmp_path / 'fwp' / 'config_fwp.json', json.load(open(fwp_fp)))
    (tmp_path / 'collect').mkdir()
    out_file = str(tmp_path / 'collected.h5')
    _collect_cfg(tmp_path / 'collect', out_pattern, out_file)
    pipe_fp = _pipeline(
        tmp_path, {'forward-pass': 'fwp/config_fwp.json'},
        {'collect-step': 'collect/config_collect.json',
         'command': 'data-collect'})
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    assert os.path.exists(out_file)
    assert (tmp_path / 'fwp' / '.status.json').exists()
    assert (tmp_path / 'collect' / '.status.json').exists()
    assert not (tmp_path / '.status.json').exists()
    mtime = os.path.getmtime(out_file)
    assert main(['-c', pipe_fp, 'pipeline', '--monitor']) == 0
    assert os.path.getmtime(out_file) == mtime
