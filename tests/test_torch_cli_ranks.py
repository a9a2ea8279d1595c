"""A forward-pass CLI node run as a group of ranks (``execution_control``
``ranks_per_node``; ``utilities.cli.run_node_group``): the counterpart
of a JAX node's local devices, which the JAX tests force to 8 on the CPU
(tests/conftest.py). Each pipeline runs from its run directory through
real node processes, with ``device: 'cpu'`` and two gloo ranks a node;
the nodes import the port from outside the repo (``node_command``).

Bars: the collected output of a group node against the one-process
node's (the same strategy run in this process, its chunks collected the
same way) within 1e-6 of its largest magnitude under ``use_mesh=True``
and 1e-4 under ``'spatial'`` and the 'auto' fallback; the one-process
output against the JAX package's in-process ``ForwardPass`` with
``use_mesh=True`` over its 8 CPU devices at the parity bar (rtol 1e-4,
atol 1e-6)."""

import glob
import json
import os
import re
import time

import numpy as np
import pytest

from sup3r_tpu_torch.cli import main
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.postprocessing.collectors import CollectorNC
from sup3r_tpu_torch.preprocessing.loaders import LoaderNC
from sup3r_tpu_torch.utilities.cli import Status
from tests.test_torch_cli import write_json

FEATURES = ['u_100m', 'v_100m']
#: (12, 12, 8) LR input; (6, 6, 4) chunks with pads 1, so 8 chunks whose
#: padded s1 (8 rows) two ranks split evenly; batches of 4
CELL = dict(fwp_chunk_shape=[6, 6, 4], spatial_pad=1, temporal_pad=1,
            device_batch_size=4)
RANKS = 2


@pytest.fixture(scope='module')
def cell(tmp_path_factory):
    """The model and input, the one-process node's collected output and
    chunk outputs, and the JAX package's ``use_mesh=True`` pass."""
    from sup3r_tpu.pipeline import ForwardPass as JaxForwardPass
    from sup3r_tpu.pipeline import ForwardPassStrategy as JaxStrategy
    from sup3r_tpu.utilities.test_helpers import make_fake_nc_file
    from tests.forward_pass.test_forward_pass import (
        _save_model,
        _st_gen_config,
    )

    root = tmp_path_factory.mktemp('cli_ranks')
    input_file = make_fake_nc_file(str(root / 'input.nc'), (12, 12, 8),
                                   ['u100', 'v100'])
    model_dir, _ = _save_model(str(root), _st_gen_config(), 3, 4)
    kw = dict(file_paths=input_file, **CELL)
    one = ForwardPassStrategy(
        model_kwargs={'model_dir': model_dir, 'device': 'cpu'},
        out_pattern=str(root / 'one' / 'chunk_{file_id}.nc'), **kw)
    ForwardPass.run(one, 0)
    CollectorNC.collect(str(root / 'one' / 'chunk_*.nc'),
                        str(root / 'one_collected.nc'))
    chunks = ForwardPass.run(ForwardPassStrategy(
        model_kwargs={'model_dir': model_dir, 'device': 'cpu'},
        out_pattern=None, **kw), 0)
    jax_chunks = JaxForwardPass.run(JaxStrategy(
        model_kwargs={'model_dir': model_dir}, out_pattern=None,
        use_mesh=True, **kw), 0)
    return {'root': root, 'input': input_file, 'model_dir': model_dir,
            'collected': _read(str(root / 'one_collected.nc')),
            'chunks': chunks, 'jax_chunks': jax_chunks}


def _read(path):
    data = LoaderNC(path).data
    return np.stack([np.asarray(data[f]) for f in FEATURES], axis=-1)


def _fwp_config(cell, run_dir, **extra):
    ctrl = {'option': 'local', 'ranks_per_node': RANKS}
    ctrl.update(extra.pop('execution_control', {}))
    return write_json(os.path.join(run_dir, 'config_fwp.json'), {
        'file_paths': cell['input'],
        'model_kwargs': {'model_dir': cell['model_dir'], 'device': 'cpu'},
        'out_pattern': './out/chunk_{file_id}.nc',
        'log_file': './logs/fwp_{node_index}.log',
        'execution_control': ctrl, **CELL, **extra})


def _pipeline(cell, name, use_mesh):
    """A pipeline whose forward-pass node is a group of two ranks: run,
    then run again; its chunks collected as the one-process node's were.
    Returns (run dir, wall s of the run, the status after it, the rerun's
    return code, the status after the rerun)."""
    run_dir = str(cell['root'] / name)
    os.makedirs(run_dir)
    _fwp_config(cell, run_dir, use_mesh=use_mesh)
    pipe = write_json(os.path.join(run_dir, 'config_pipeline.json'), {
        'pipeline': [{'forward-pass': 'config_fwp.json'}]})
    t0 = time.perf_counter()
    assert main(['-c', pipe, 'pipeline', '--monitor']) == 0
    wall = time.perf_counter() - t0
    status = Status(run_dir).read()
    rerun = main(['-c', pipe, 'pipeline', '--monitor'])
    CollectorNC.collect(os.path.join(run_dir, 'out', 'chunk_*.nc'),
                        os.path.join(run_dir, 'collected.nc'))
    return run_dir, wall, status, rerun, Status(run_dir).read()


@pytest.fixture(scope='module')
def groups(cell):
    """The pipeline under use_mesh True and 'spatial' (no PYTHONPATH, one
    thread a process)."""
    saved = {k: os.environ.get(k) for k in ('PYTHONPATH', 'OMP_NUM_THREADS')}
    os.environ.pop('PYTHONPATH', None)
    os.environ['OMP_NUM_THREADS'] = '1'
    try:
        return {mode: _pipeline(cell, f'group_{mode}', mode)
                for mode in (True, 'spatial')}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _summaries(path, what):
    with open(path) as f:
        lines = [x for x in f if f'{what}: ' in x]
    return [json.loads(x.split(f'{what}: ', 1)[1]) for x in lines]


def test_one_process_node_matches_jax_mesh_pass(cell):
    """The one-process node's chunks against the JAX package's
    ``use_mesh=True`` pass (8 CPU devices) at the parity bar."""
    ref = cell['jax_chunks']
    assert sorted(cell['chunks']) == sorted(ref) and len(ref) == 8
    for idx in ref:
        np.testing.assert_allclose(cell['chunks'][idx], ref[idx],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('mode,tol', [(True, 1e-6), ('spatial', 1e-4)])
def test_group_node_collected_output(cell, groups, mode, tol):
    """The collected output of the pipeline whose node is two ranks
    equals the one-process node's."""
    run_dir = groups[mode][0]
    got = _read(os.path.join(run_dir, 'collected.nc'))
    want = cell['collected']
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize('mode', [True, 'spatial'])
def test_one_status_entry_per_node_and_rerun_skips(groups, mode):
    """One status entry for the node (never one per rank), successful;
    the rerun starts nothing and leaves the store as it was."""
    _, _, status, rerun, after = groups[mode]
    fwp = [k for k in status if k.startswith('forward-pass#')]
    assert len(fwp) == 1
    jobs = status[fwp[0]]
    assert len(jobs) == 1
    assert all(j['job_status'] == 'successful' for j in jobs.values())
    assert rerun == 0 and after == status


@pytest.mark.parametrize('mode', [True, 'spatial'])
def test_ranks_log_to_files_of_their_own(groups, mode):
    """The launcher and each rank log to files of their own: the group's
    summary in the node's file, one ``Node summary`` a rank, with its
    rank, in the rank's file; in a 'spatial' group both ranks run every
    dispatch, under True each half of the chunks."""
    run_dir = groups[mode][0]
    logs = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(run_dir, 'logs', '*')))
    assert logs == ['fwp_0.log', 'fwp_0_rank0.log', 'fwp_0_rank1.log']
    group, = _summaries(os.path.join(run_dir, 'logs', 'fwp_0.log'),
                        'Group summary')
    assert group['ranks'] == RANKS
    assert group['exit_codes'] == [0, 0] and group['wall_s'] > 0
    for r in range(RANKS):
        path = os.path.join(run_dir, 'logs', f'fwp_0_rank{r}.log')
        with open(path) as f:
            text = f.read()
        assert text.count('Node logging to') == 1
        summary, = _summaries(path, 'Node summary')
        assert (summary['rank'], summary['ranks']) == (r, RANKS)
        assert summary['backend'] == 'gloo'
        assert summary['startup_s'] > summary['import_s'] > 0
        assert summary['launches'] == {'small_reflect_conv': 0,
                                       'reflect_conv': 0}
        finished = re.search(r'Node 0 finished (\d+) chunks', text)
        assert int(finished.group(1)) == (8 if mode == 'spatial' else 4)


def test_ranks_without_use_mesh_raise(cell, tmp_path):
    """``ranks_per_node`` > 1 with neither ``use_mesh`` nor 'auto' would
    run every chunk on every rank: the command raises before any node
    starts."""
    fwp = _fwp_config(cell, str(tmp_path))
    with pytest.raises(ValueError, match='every chunk'):
        main(['-c', fwp, 'forward-pass'])
    assert not Status(str(tmp_path)).read()
    assert not os.path.exists(tmp_path / 'out')


def test_failing_rank_fails_the_node(cell, tmp_path, monkeypatch):
    """Rank 1 dies before the rendezvous (its log directory is a file):
    the launcher kills rank 0, which waits there, at once, the node is
    recorded as failed with rank 1's error, and no rank is left
    running."""
    monkeypatch.delenv('PYTHONPATH', raising=False)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    os.makedirs(tmp_path / 'logs')
    (tmp_path / 'logs' / 'r1').write_text('not a directory')
    fwp = _fwp_config(cell, str(tmp_path), use_mesh=True,
                      log_file='./logs/r{rank}/fwp_{node_index}.log',
                      execution_control={'ranks_timeout': 120})
    t0 = time.perf_counter()
    assert main(['-c', fwp, 'forward-pass']) == 1
    assert time.perf_counter() - t0 < 60
    status = Status(str(tmp_path)).read()
    job, = status['forward-pass'].values()
    assert job['job_status'] == 'failed'
    assert 'rank 1 of 2 exited 1' in job['stderr']
    group, = _summaries(str(tmp_path / 'logs' / 'rgroup' / 'fwp_0.log'),
                        'Group summary')
    assert group['exit_codes'][1] == 1 and group['exit_codes'][0] < 0
    cfg_fp, = glob.glob(str(tmp_path / '.forward-pass_*_node0.json'))
    for pid in (p for p in os.listdir('/proc') if p.isdigit()):
        try:
            with open(f'/proc/{pid}/cmdline', 'rb') as f:
                cmdline = f.read().decode(errors='replace')
        except OSError:
            continue
        assert cfg_fp not in cmdline, f'a rank is still running: {pid}'
    assert not glob.glob(cfg_fp + '.store.*')


@pytest.mark.parametrize('budget_gb,plan,chunks', [
    ('1e-7', 'use_mesh="spatial" over 2 rank(s)', 8),
    ('10', 'use_mesh=True (chunk fan-out)', 4)])
def test_auto_batch_in_a_group(cell, tmp_path, monkeypatch, budget_gb,
                               plan, chunks):
    """``device_batch_size='auto'`` in a two-rank node: with a budget too
    small for one padded chunk (``SUP3R_TPU_HBM_GB``, the JAX package's
    override) the node switches to ``use_mesh='spatial'`` over its ranks,
    where a one-process node raises; with room, the ranks fan the chunks
    out instead of each running all of them. Either way the output is
    the one-process node's."""
    monkeypatch.delenv('PYTHONPATH', raising=False)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    monkeypatch.setenv('SUP3R_TPU_HBM_GB', budget_gb)
    fwp = _fwp_config(cell, str(tmp_path), device_batch_size='auto')
    assert main(['-c', fwp, 'forward-pass']) == 0
    for r in range(RANKS):
        with open(tmp_path / 'logs' / f'fwp_0_rank{r}.log') as f:
            text = f.read()
        assert plan in text
        finished = re.search(r'Node 0 finished (\d+) chunks', text)
        assert int(finished.group(1)) == chunks
    CollectorNC.collect(str(tmp_path / 'out' / 'chunk_*.nc'),
                        str(tmp_path / 'collected.nc'))
    got = _read(str(tmp_path / 'collected.nc'))
    want = cell['collected']
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
