"""The port's command line (``python -m sup3r_tpu_torch.cli``) on the
CPU, through real node processes: the cases of tests/pipeline/test_cli.py
and test_slurm_status.py's cancel case, ported. Every node runs with
``device: 'cpu'`` in its config, from its run directory, with no
``PYTHONPATH`` of its own: the node command puts the port on it.

The JAX package's own CLI tests cannot import ``sup3r_tpu`` in their
node processes (its node command is a bare ``python -c`` run from the
run directory), so these hold the port's CLI to the JAX package's
modules run in-process (test_torch_cli_production.py) and to its job
store (test_torch_cli_status.py). Pipelines and batches are in
test_torch_cli_pipeline.py."""

import glob
import json
import os
import shlex
import subprocess
import sys

import h5py
import numpy as np
import pytest

from sup3r_tpu.utilities.test_helpers import (
    make_fake_h5_file,
    make_fake_nc_file,
)
from sup3r_tpu_torch.cli import _node_cmd, main
from sup3r_tpu_torch.utilities.cli import BaseCLI, Status
from tests.forward_pass.test_forward_pass import _s_gen_config, _save_model


@pytest.fixture(autouse=True)
def node_env(monkeypatch):
    """Node processes inherit no ``PYTHONPATH`` and one CPU thread each
    (the suite runs several test files at once)."""
    monkeypatch.delenv('PYTHONPATH', raising=False)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')


def write_json(path, cfg):
    with open(path, 'w') as f:
        json.dump(cfg, f)
    return str(path)


@pytest.fixture
def fwp_setup(tmp_path):
    """A u / v NetCDF input, a spatial 2x model saved by the JAX package
    and a forward-pass config on the CPU writing four H5 chunks."""
    input_file = make_fake_nc_file(str(tmp_path / 'input.nc'),
                                   (10, 10, 4), ['u100', 'v100'])
    model_dir, _ = _save_model(tmp_path, _s_gen_config(), 2, 1,
                               is_5d=False)
    out_pattern = str(tmp_path / 'out' / 'chunk_{file_id}.h5')
    fwp_fp = write_json(tmp_path / 'config_fwp.json', {
        'file_paths': input_file,
        'model_kwargs': {'model_dir': model_dir, 'device': 'cpu'},
        'model_class': 'Sup3rGan',
        'fwp_chunk_shape': [5, 5, 4],
        'spatial_pad': 1,
        'temporal_pad': 0,
        'out_pattern': out_pattern,
        'execution_control': {'option': 'local'},
    })
    return tmp_path, fwp_fp, out_pattern


def test_cli_forward_pass(fwp_setup):
    """One node runs the four chunks; the head ships its frozen plan."""
    tmp_path, fwp_fp, _ = fwp_setup
    assert main(['-c', fwp_fp, 'forward-pass']) == 0
    assert len(list((tmp_path / 'out').glob('*.h5'))) == 4
    status = Status(str(tmp_path)).read()
    assert status['forward-pass']
    assert all(j['job_status'] == 'successful'
               for j in status['forward-pass'].values())
    node_cfgs = sorted(tmp_path.glob('.forward-pass_*_node*.json'))
    assert node_cfgs
    plan = json.load(open(node_cfgs[0]))['node_chunks_plan']
    assert sorted(i for c in plan for i in c) == [0, 1, 2, 3]


def test_cli_per_node_log_files(fwp_setup):
    """``log_file`` gives each node its own log; the key never reaches
    the strategy. Two nodes; each logs its summary line."""
    tmp_path, fwp_fp, _ = fwp_setup
    cfg = json.load(open(fwp_fp))
    cfg.update(log_file=str(tmp_path / 'logs' / 'fwp_{node_index}.log'),
               log_level='DEBUG', max_nodes=2)
    write_json(fwp_fp, cfg)
    assert main(['-c', fwp_fp, 'forward-pass']) == 0
    logs = sorted((tmp_path / 'logs').glob('fwp_*.log'))
    assert [p.name for p in logs] == ['fwp_0.log', 'fwp_1.log']
    for i, log in enumerate(logs):
        text = log.read_text()
        assert 'Node logging to' in text
        assert 'chunk' in text.lower()
        line = next(x for x in text.splitlines() if 'Node summary' in x)
        summary = json.loads(line.split('Node summary: ', 1)[1])
        assert summary['node_index'] == i
        assert summary['startup_s'] > summary['import_s'] > 0
        assert summary['run_s'] > 0
        # on the CPU the wrappers take the plain versions: no launches
        assert summary['launches'] == {'small_reflect_conv': 0,
                                       'reflect_conv': 0}


def test_cli_requires_config(tmp_path, capsys):
    assert main(['forward-pass']) == 1
    assert 'config file is required' in capsys.readouterr().err
    with pytest.raises(SystemExit) as info:
        main(['-c', str(tmp_path / 'missing.json'), 'qa'])
    assert info.value.code == 2
    with pytest.raises(SystemExit):
        main(['-c', str(tmp_path / 'missing.json'), 'no-such-command'])


def test_nodes_without_a_card_raise(fwp_setup):
    """A forward-pass or qa node whose config names no device takes the
    card; with none it fails, and the head refuses first."""
    tmp_path, fwp_fp, out_pattern = fwp_setup
    cfg = json.load(open(fwp_fp))
    cfg['model_kwargs'].pop('device')
    no_dev = write_json(tmp_path / 'config_nodev.json', cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        main(['-c', no_dev, 'forward-pass'])
    run_cfg = {k: v for k, v in cfg.items() if k != 'execution_control'}
    qa_cfg = {'source_file_paths': cfg['file_paths'],
              'out_file_path': cfg['file_paths'], 's_enhance': 1,
              't_enhance': 1, 'features': ['u_100m']}
    cmds = [_node_cmd('forward-pass', run_cfg, 0, str(tmp_path)),
            _node_cmd('qa', qa_cfg, 0, str(tmp_path))]
    codes = BaseCLI.kickoff_jobs('nodev', cmds,
                                 {'run_dir': str(tmp_path / 'nodev')})
    assert all(codes)
    jobs = Status(str(tmp_path / 'nodev')).read()['nodev']
    for job in jobs.values():
        assert job['job_status'] == 'failed'
        assert 'no CUDA device' in job['stderr']
    assert not (tmp_path / 'out').exists()


def test_node_cmd_quotes_special_run_dirs(tmp_path):
    """A run_dir holding shell metacharacters survives the shell=True
    launch: the payload is one shlex-quoted argument with the literal
    path, run by this interpreter."""
    weird = tmp_path / 'run$1 dir`x'
    weird.mkdir()
    cmd = _node_cmd('qa', {'log_level': 'INFO'}, 0, str(weird))
    parts = shlex.split(cmd)
    assert parts[0].startswith('PYTHONPATH=')
    assert parts[1:3] == [sys.executable, '-c']
    assert len(parts) == 4
    assert str(weird) in parts[3]
    out = subprocess.run(
        f'{shlex.quote(sys.executable)} -c "import sys; '
        f'print(sys.argv[1])" {shlex.quote(parts[3])}', shell=True,
        capture_output=True, text=True, timeout=60)
    assert str(weird) in out.stdout
    cfgs = list(weird.glob('.qa_*_node0.json'))
    assert len(cfgs) == 1 and json.load(open(cfgs[0]))['node_index'] == 0


def test_cli_bias_calc(tmp_path):
    """bias-calc runs its jobs in-process and records their status; the
    factors equal the JAX package's. A config-level device is passed
    only to the calculations that take one (LinearCorrection does not);
    a failing job is recorded before it raises."""
    base_fp = make_fake_h5_file(
        str(tmp_path / 'base.h5'), (20, 20, 480), ['windspeed_100m'],
        freq='h', value_range=(0, 20), lat_range=(40.0, 39.0),
        lon_range=(-105.5, -104.3))
    bias_fp = make_fake_nc_file(
        str(tmp_path / 'bias.nc'), (10, 10, 100), ['u100'], freq='D',
        lat_range=(40.0, 39.0), lon_range=(-105.5, -104.3))
    fp_out = str(tmp_path / 'factors.h5')
    job = {'base_fps': base_fp, 'bias_fps': bias_fp,
           'base_dset': 'windspeed_100m', 'bias_feature': 'u_100m'}
    cfg_fp = write_json(tmp_path / 'config_bc.json', {
        'run_dir': str(tmp_path), 'device': 'cpu',
        'jobs': [{'bias_calc_class': 'LinearCorrection', 'fp_out': fp_out,
                  **job}]})
    assert main(['-c', cfg_fp, 'bias-calc']) == 0
    with h5py.File(fp_out, 'r') as f:
        assert 'u_100m_scalar' in f
        scalar = f['u_100m_scalar'][:]
    from sup3r_tpu.bias import LinearCorrection as JaxLinear

    want = JaxLinear(**job).run()['u_100m_scalar']
    np.testing.assert_allclose(scalar, want, rtol=1e-4)
    status = Status(str(tmp_path)).read()
    assert status['bias-calc']['bias_calc_0']['job_status'] == 'successful'

    bad_fp = write_json(tmp_path / 'config_bad.json', {
        'run_dir': str(tmp_path / 'bad'), 'jobs': [
            {'bias_calc_class': 'LinearCorrection', **job,
             'bias_feature': 'not_a_feature'}]})
    with pytest.raises(Exception):
        main(['-c', bad_fp, 'bias-calc'])
    bad = Status(str(tmp_path / 'bad')).read()['bias-calc']['bias_calc_0']
    assert bad['job_status'] == 'failed' and bad['error']


def test_cli_collect_and_qa(fwp_setup):
    """forward-pass, data-collect and qa as separate commands: the QA of
    the collected file (ws / wd from the u / v source) is exported."""
    tmp_path, fwp_fp, out_pattern = fwp_setup
    assert main(['-c', fwp_fp, 'forward-pass']) == 0
    collected = str(tmp_path / 'collected.h5')
    collect_fp = write_json(tmp_path / 'config_collect.json', {
        'run_dir': str(tmp_path),
        'file_paths': out_pattern.replace('{file_id}', '*'),
        'out_file': collected})
    assert main(['-c', collect_fp, 'data-collect']) == 0
    with h5py.File(collected, 'r') as f:
        assert f['windspeed_100m'].shape == (4, 400)
    qa_fp = str(tmp_path / 'qa.h5')
    qa_cfg = write_json(tmp_path / 'config_qa.json', {
        'run_dir': str(tmp_path),
        'source_file_paths': json.load(open(fwp_fp))['file_paths'],
        'out_file_path': collected, 's_enhance': 2, 't_enhance': 1,
        'temporal_coarsening_method': 'subsample', 'qa_fp': qa_fp,
        'device': 'cpu'})
    assert main(['-c', qa_cfg, 'qa']) == 0
    with h5py.File(qa_fp, 'r') as f:
        assert {'windspeed_100m_error', 'winddirection_100m_error'} <= set(f)
        assert f['windspeed_100m_error'].shape == (10, 10, 4)


def test_cli_fwp_with_bias_correction(tmp_path):
    """A forward-pass config's bias_correct_method reaches the nodes:
    +5 m/s on both components raises the mean windspeed."""
    input_file = make_fake_nc_file(str(tmp_path / 'input.nc'),
                                   (10, 10, 4), ['u100', 'v100'])
    model_dir, _ = _save_model(tmp_path, _s_gen_config(), 2, 1,
                               is_5d=False)

    def run(tag, **extra):
        fp = write_json(tmp_path / f'config_{tag}.json', {
            'file_paths': input_file,
            'model_kwargs': {'model_dir': model_dir, 'device': 'cpu'},
            'model_class': 'Sup3rGan', 'fwp_chunk_shape': [10, 10, 4],
            'spatial_pad': 0, 'temporal_pad': 0,
            'out_pattern': str(tmp_path / tag / 'chunk_{file_id}.h5'),
            'execution_control': {'option': 'local'}, **extra})
        assert main(['-c', fp, 'forward-pass']) == 0
        out = sorted((tmp_path / tag).glob('*.h5'))[0]
        with h5py.File(out, 'r') as f:
            return f['windspeed_100m'][:] / f['windspeed_100m'].attrs[
                'scale_factor']

    plain = run('plain')
    bc = run('bc', bias_correct_method='global_linear_bc',
             bias_correct_kwargs={
                 'u_100m': {'scalar': 1.0, 'adder': 5.0},
                 'v_100m': {'scalar': 1.0, 'adder': 5.0}})
    assert not np.allclose(plain, bc)
    assert bc.mean() > plain.mean()


def test_pipeline_cancel_marks_jobs(tmp_path):
    """pipeline --cancel marks pending / running jobs canceled (scancel
    is absent here) and leaves terminal jobs alone."""
    status = Status(str(tmp_path))
    status.update('forward-pass', 'fwd_0', job_status='submitted',
                  job_id='12345')
    status.update('forward-pass', 'fwd_1', job_status='successful')
    status.update('data-collect', 'col_0', job_status='running',
                  job_id='12346')
    pipe_fp = write_json(tmp_path / 'config_pipeline.json',
                         {'pipeline': [{'forward-pass': 'x.json'}]})
    assert main(['-c', pipe_fp, 'pipeline', '--cancel']) == 0
    after = status.read()
    assert after['forward-pass']['fwd_0']['job_status'] == 'canceled'
    assert after['forward-pass']['fwd_1']['job_status'] == 'successful'
    assert after['data-collect']['col_0']['job_status'] == 'canceled'


def test_cli_import_model(tmp_path, capsys):
    """import-model converts a reference checkpoint directory, and a
    multi-step bundle step by step, into model directories the
    forward pass loads."""
    from sup3r_tpu_torch.configs import get_config
    from sup3r_tpu_torch.models import Sup3rGan
    from sup3r_tpu_torch.utilities.port import export_reference_gan

    model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                     get_config('spatiotemporal/disc_test'), device='cpu')
    model.meta.update(lr_features=['u_100m', 'v_100m'],
                      hr_out_features=['u_100m', 'v_100m'], s_enhance=3,
                      t_enhance=4)
    model.init_weights((1, 4, 4, 4, 2), (1, 12, 12, 16, 2))
    ref = tmp_path / 'ref'
    export_reference_gan(model, str(ref))
    assert main(['import-model', str(ref), str(tmp_path / 'out'),
                 '--lr-shape', '1,4,4,4,2', '--device', 'cpu']) == 0
    assert '3x spatial / 4x temporal' in capsys.readouterr().out
    back = Sup3rGan.load(str(tmp_path / 'out'), device='cpu')
    x = np.random.default_rng(0).random((1, 4, 4, 4, 2)).astype(
        np.float32)
    np.testing.assert_allclose(back.generate(x), model.generate(x),
                               rtol=1e-5, atol=1e-6)
    bundle = tmp_path / 'bundle'
    for step in ('model_step_0', 'model_step_1'):
        export_reference_gan(model, str(bundle / step))
    assert main(['import-model', str(bundle), str(tmp_path / 'steps'),
                 '--lr-shape', '1,4,4,4,2', '--device', 'cpu']) == 0
    assert sorted(glob.glob(str(tmp_path / 'steps' / '*' /
                                'model_params.json')))
    assert len(os.listdir(tmp_path / 'steps')) == 2
