"""The port's CLI job store (``sup3r_tpu_torch.utilities.cli``: ``Status``,
``BaseCLI``) against the JAX package's (``sup3r_tpu.utilities.cli``) on
the same call sequences: the cases of tests/pipeline/test_status_legacy.py
and test_slurm_status.py, each run through both packages in run
directories of their own. Every case's assertions hold for both, and
the two ``.status.json`` files are identical once the record times and
the run directories are taken out. Node commands differ (the module
path and the launcher) but are not recorded in the store."""

import json
import os
import shlex
import stat
import subprocess
import sys

import pytest

import sup3r_tpu.utilities.cli as jax_cli
import sup3r_tpu_torch.utilities.cli as port_cli


def _write_raw(cli, run_dir, payload):
    with open(os.path.join(str(run_dir), cli.STATUS_FILE), 'w') as f:
        json.dump(payload, f)


def _fake_sbatch(tmp_path, run_immediately=True, job_id=4242):
    """A fake sbatch executable: prints the standard submission line
    and (optionally) runs the script synchronously in bash, so the
    sentinel exit file appears like a completed cluster job."""
    fp = tmp_path / 'fake_sbatch'
    body = '#!/bin/bash\n'
    if run_immediately:
        body += 'bash "$1" > /dev/null 2>&1\n'
    body += f'echo "Submitted batch job {job_id}"\n'
    fp.write_text(body)
    fp.chmod(fp.stat().st_mode | stat.S_IEXEC)
    return str(fp)


# -- tests/pipeline/test_status_legacy.py ----------------------------------
def case_round1_format_skips(cli, tmp_path):
    _write_raw(cli, tmp_path, {
        'forward-pass': {
            'forward-pass_0': {'job_status': 'successful'},
            'forward-pass_1': {'job_status': 'successful'},
        },
    })
    st = cli.Status(str(tmp_path))
    assert st.module_successful('forward-pass#ab12cd')
    assert st.job_status('forward-pass#ab12cd',
                         'forward-pass#ab12cd_9f3e21_0') == 'successful'
    assert st.job_status('forward-pass#ab12cd',
                         'forward-pass#ab12cd_9f3e21_1') == 'successful'
    assert st.job_status('forward-pass#ab12cd',
                         'forward-pass#ab12cd_9f3e21_2') is None
    assert not st.module_successful('data-collect#ab12cd')
    return str(tmp_path)


def case_indexed_format_is_ambiguous(cli, tmp_path):
    _write_raw(cli, tmp_path, {
        'forward-pass-0': {
            'forward-pass-0_0': {'job_status': 'successful'}},
        'forward-pass-1': {
            'forward-pass-1_0': {'job_status': 'successful'}},
    })
    st = cli.Status(str(tmp_path))
    assert not st.module_successful('forward-pass#aaaaaa')
    assert st.job_status('forward-pass#aaaaaa',
                         'forward-pass#aaaaaa_bbbbbb_0') is None
    _write_raw(cli, tmp_path, {
        'forward-pass-1': {
            'forward-pass-1_0': {'job_status': 'successful'}},
    })
    assert st.module_successful('forward-pass#aaaaaa')
    return str(tmp_path)


def case_versioned_store_keeps_isolation(cli, tmp_path):
    _write_raw(cli, tmp_path, {
        '__version__': cli.STATUS_VERSION,
        'forward-pass': {
            'forward-pass_0': {'job_status': 'successful'}},
    })
    st = cli.Status(str(tmp_path))
    assert not st.module_successful('forward-pass#ab12cd')
    assert st.job_status('forward-pass#ab12cd',
                         'forward-pass#ab12cd_x_0') is None
    assert st.module_successful('forward-pass')
    return str(tmp_path)


def case_run_local_skips_on_legacy_record(cli, tmp_path):
    _write_raw(cli, tmp_path, {
        'forward-pass': {
            'forward-pass_0': {'job_status': 'successful'}},
    })
    rc = cli.BaseCLI.run_local('false', 'forward-pass#ab12cd',
                               'forward-pass#ab12cd_9f3e21_0',
                               str(tmp_path))
    assert rc == 0
    assert cli.Status(str(tmp_path)).job_status(
        'forward-pass#ab12cd', 'forward-pass#ab12cd_9f3e21_0'
    ) == 'successful'
    return str(tmp_path)


def case_update_stamps_version_and_poll_ignores_it(cli, tmp_path):
    st = cli.Status(str(tmp_path))
    st.update('forward-pass#ab', 'forward-pass#ab_x_0',
              job_status='successful')
    assert st.read()['__version__'] == cli.STATUS_VERSION
    st.poll(squeue_fn=lambda j: None, sacct_fn=lambda j: None)
    _write_raw(cli, tmp_path, {
        'solar': {'solar_0': {'job_status': 'successful'}}})
    st.update('qa#ff', 'qa#ff_x_0', job_status='running')
    assert st.module_successful('solar#abcdef')
    return str(tmp_path)


def case_poll_transitions_legacy_jobs(cli, tmp_path):
    exit_fp = str(tmp_path / '.fwd.exit')
    with open(exit_fp, 'w') as f:
        f.write('0')
    _write_raw(cli, tmp_path, {
        'forward-pass': {
            'forward-pass_0': {'job_status': 'submitted',
                               'exit_file': exit_fp}},
    })
    st = cli.Status(str(tmp_path))
    st.poll('forward-pass#ab12cd',
            squeue_fn=lambda j: None, sacct_fn=lambda j: None)
    assert st.job_status('forward-pass#ab12cd',
                         'forward-pass#ab12cd_x_0') == 'successful'
    assert st.module_successful('forward-pass#ab12cd')
    return str(tmp_path)


def case_clear_failed_keeps_successes(cli, tmp_path):
    st = cli.Status(str(tmp_path))
    st.update('qa#aa', 'qa#aa_x_0', job_status='failed', stderr='boom')
    st.update('qa#aa', 'qa#aa_x_1', job_status='successful')
    assert st.module_failed('qa#aa')
    st.clear_failed('qa#aa')
    assert not st.module_failed('qa#aa')
    assert st.module_successful('qa#aa')
    return str(tmp_path)


# -- tests/pipeline/test_slurm_status.py -----------------------------------
def case_submit_success_via_sentinel(cli, tmp_path):
    run_dir = str(tmp_path / 'run')
    rc = cli.BaseCLI.run_slurm('true', 'forward-pass', 'fwd_0', run_dir,
                               sbatch=_fake_sbatch(tmp_path))
    assert rc == 0
    status = cli.Status(run_dir)
    job = status.read()['forward-pass']['fwd_0']
    assert job['job_status'] == 'submitted'
    assert job['job_id'] == '4242'
    assert os.path.exists(job['exit_file'])
    status.poll('forward-pass')
    job = status.read()['forward-pass']['fwd_0']
    assert job['job_status'] == 'successful'
    assert job['exit_code'] == '0'
    assert status.module_successful('forward-pass')
    return run_dir


def case_submit_failure_via_sentinel(cli, tmp_path):
    run_dir = str(tmp_path / 'run')
    cli.BaseCLI.run_slurm('exit 3', 'forward-pass', 'fwd_0', run_dir,
                          sbatch=_fake_sbatch(tmp_path))
    status = cli.Status(run_dir)
    status.poll()
    job = status.read()['forward-pass']['fwd_0']
    assert job['job_status'] == 'failed'
    assert job['exit_code'] == '3'
    assert status.module_failed('forward-pass')
    assert not status.module_successful('forward-pass')
    return run_dir


def case_poll_via_squeue_sacct_hooks(cli, tmp_path):
    run_dir = str(tmp_path / 'run')
    cli.BaseCLI.run_slurm('true', 'solar', 's_0', run_dir,
                          sbatch=_fake_sbatch(tmp_path, False, 77))
    status = cli.Status(run_dir)
    assert status.job_status('solar', 's_0') == 'submitted'
    status.poll(squeue_fn=lambda j: 'PENDING', sacct_fn=lambda j: None)
    assert status.job_status('solar', 's_0') == 'submitted'
    status.poll(squeue_fn=lambda j: 'RUNNING', sacct_fn=lambda j: None)
    assert status.job_status('solar', 's_0') == 'running'
    status.poll(squeue_fn=lambda j: None, sacct_fn=lambda j: 'COMPLETED')
    assert status.job_status('solar', 's_0') == 'successful'
    return run_dir


def case_poll_sacct_terminal_failures(cli, tmp_path):
    run_dir = str(tmp_path / 'run')
    cli.BaseCLI.run_slurm('true', 'qa', 'q_0', run_dir,
                          sbatch=_fake_sbatch(tmp_path, False, 78))
    status = cli.Status(run_dir)
    status.poll(squeue_fn=lambda j: None, sacct_fn=lambda j: 'TIMEOUT')
    job = status.read()['qa']['q_0']
    assert job['job_status'] == 'failed'
    assert job['slurm_state'] == 'TIMEOUT'
    return run_dir


def case_no_evidence_keeps_state(cli, tmp_path):
    run_dir = str(tmp_path / 'run')
    cli.BaseCLI.run_slurm('true', 'qa', 'q_0', run_dir,
                          sbatch=_fake_sbatch(tmp_path, False, 79))
    status = cli.Status(run_dir)
    status.poll(squeue_fn=lambda j: None, sacct_fn=lambda j: None)
    assert status.job_status('qa', 'q_0') == 'submitted'
    return run_dir


def case_successful_job_not_resubmitted(cli, tmp_path):
    run_dir = str(tmp_path / 'run')
    sbatch = _fake_sbatch(tmp_path)
    cli.BaseCLI.run_slurm('true', 'fp', 'j0', run_dir, sbatch=sbatch)
    cli.Status(run_dir).poll()
    script = os.path.join(run_dir, 'j0.sbatch')
    mtime = os.path.getmtime(script)
    rc = cli.BaseCLI.run_slurm('false', 'fp', 'j0', run_dir, sbatch=sbatch)
    assert rc == 0
    assert os.path.getmtime(script) == mtime
    assert cli.Status(run_dir).job_status('fp', 'j0') == 'successful'
    return run_dir


def case_kickoff_jobs_slurm_with_injected_sbatch(cli, tmp_path):
    run_dir = tmp_path / 'run'
    codes = cli.BaseCLI.kickoff_jobs(
        'forward-pass', ['true', 'true'],
        {'run_dir': str(run_dir),
         'execution_control': {'option': 'slurm',
                               'sbatch': _fake_sbatch(tmp_path),
                               'walltime': 1}})
    assert codes == [0, 0]
    status = cli.Status(str(run_dir))
    jobs = status.read()['forward-pass']
    assert sorted(jobs) == ['forward-pass_0', 'forward-pass_1']
    assert all(j['job_status'] in ('submitted', 'successful')
               for j in jobs.values())
    status.poll()
    assert status.module_successful('forward-pass')
    return str(run_dir)


def case_kickoff_jobs_local_with_tag(cli, tmp_path):
    run_dir = tmp_path / 'run'
    codes = cli.BaseCLI.kickoff_jobs(
        'qa#abc', ['true', 'exit 2'],
        {'run_dir': str(run_dir)}, job_tag='def')
    assert codes == [0, 2]
    jobs = cli.Status(str(run_dir)).read()['qa#abc']
    assert jobs['qa#abc_def_0']['job_status'] == 'successful'
    assert jobs['qa#abc_def_1']['job_status'] == 'failed'
    return str(run_dir)


def case_missing_sbatch_binary_marks_failed(cli, tmp_path):
    run_dir = str(tmp_path / 'run')
    rc = cli.BaseCLI.run_slurm('true', 'fp', 'j0', run_dir,
                               sbatch='/nonexistent/sbatch')
    assert rc != 0
    assert cli.Status(run_dir).job_status('fp', 'j0') == 'failed'
    return run_dir


def case_live_job_not_resubmitted(cli, tmp_path):
    run_dir = str(tmp_path / 'run')
    sbatch = _fake_sbatch(tmp_path, run_immediately=False, job_id=90)
    cli.BaseCLI.run_slurm('true', 'fp', 'j0', run_dir, sbatch=sbatch)
    status = cli.Status(run_dir)
    assert status.job_status('fp', 'j0') == 'submitted'
    script = os.path.join(run_dir, 'j0.sbatch')
    mtime = os.path.getmtime(script)
    exit_fp = status.read()['fp']['j0']['exit_file']
    rc = cli.BaseCLI.run_slurm('true', 'fp', 'j0', run_dir, sbatch=sbatch)
    assert rc == 0
    assert os.path.getmtime(script) == mtime
    assert not os.path.exists(exit_fp)
    assert status.job_status('fp', 'j0') == 'submitted'
    with open(exit_fp, 'w') as f:
        f.write('1')
    rc = cli.BaseCLI.run_slurm('true', 'fp', 'j0', run_dir, sbatch=sbatch)
    assert rc == 0
    assert cli.Status(run_dir).job_status('fp', 'j0') == 'submitted'
    return run_dir


def case_walltime_string_config(cli, tmp_path):
    run_dir = str(tmp_path / 'run')
    cli.BaseCLI.run_slurm('true', 'fp', 'j0', run_dir,
                          sbatch=_fake_sbatch(tmp_path, False, 91),
                          walltime='0.5')
    with open(os.path.join(run_dir, 'j0.sbatch')) as f:
        assert '#SBATCH --time=30\n' in f.read()
    return run_dir


CASES = [v for k, v in sorted(globals().items()) if k.startswith('case_')]


def _normalized(run_dir):
    """A store with the record times dropped and the run directory
    written as ``<run>``."""
    with open(os.path.join(run_dir, port_cli.STATUS_FILE)) as f:
        text = f.read().replace(run_dir, '<run>')
    store = json.loads(text)
    for jobs in store.values():
        if isinstance(jobs, dict):
            for job in jobs.values():
                if isinstance(job, dict):
                    job.pop('time', None)
    return store


@pytest.mark.parametrize('case', CASES, ids=lambda c: c.__name__[5:])
def test_store_matches_jax(tmp_path, case):
    """Each call sequence gives the same store in both packages."""
    stores = {}
    for name, cli in (('port', port_cli), ('jax', jax_cli)):
        d = tmp_path / name
        d.mkdir()
        stores[name] = _normalized(case(cli, d))
    assert stores['port'] == stores['jax']


def test_init_node_logger_on_port_tree(tmp_path):
    """Node log files take the ``{node_index}`` pattern (or a
    ``_node{i}`` suffix) and carry the port's logger tree."""
    import logging

    root = logging.getLogger()
    before = list(root.handlers)
    try:
        fp = port_cli.init_node_logger(
            str(tmp_path / 'logs' / 'n_{node_index}.log'), 'DEBUG', 3)
        assert fp == str(tmp_path / 'logs' / 'n_3.log')
        logging.getLogger('sup3r_tpu_torch.pipeline').info('hello node')
        fp2 = port_cli.init_node_logger(str(tmp_path / 'x.log'), 'INFO', 1)
        assert fp2 == str(tmp_path / 'x_node1.log')
    finally:
        for h in root.handlers[len(before):]:
            h.close()
        root.handlers[:] = before
    assert 'hello node' in open(fp).read()
    assert logging.getLogger('sup3r_tpu_torch').level == logging.INFO
    assert port_cli.init_node_logger(None) is None


def test_node_command_imports_port_from_any_dir(tmp_path):
    """``node_command`` runs this interpreter with the port first on
    ``PYTHONPATH`` (what was there stays after it), from a directory
    outside the repo with no ``PYTHONPATH`` of its own, and passes a
    payload with shell metacharacters through as written."""
    weird = tmp_path / 'run$1 dir`x "q"'
    weird.mkdir()
    payload = ('import os, sys, sup3r_tpu_torch; '
               f'print(os.path.dirname(os.path.dirname('
               f'sup3r_tpu_torch.__file__))); print({str(weird)!r}); '
               "print(os.environ['PYTHONPATH'])")
    cmd = port_cli.node_command(payload)
    assert shlex.split(cmd)[1:3] == [sys.executable, '-c']
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    for extra, tail in ((None, ''), ('/some/where', ':/some/where')):
        if extra:
            env['PYTHONPATH'] = extra
        out = subprocess.run(cmd, shell=True, capture_output=True,
                             text=True, cwd=str(weird), env=env,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        root, path, pp = out.stdout.splitlines()
        assert root == port_cli.PACKAGE_ROOT
        assert path == str(weird)
        assert pp == port_cli.PACKAGE_ROOT + tail


def test_load_config_reads_json(tmp_path):
    fp = tmp_path / 'c.json'
    fp.write_text('{"a": [1, 2]}')
    assert port_cli.load_config(str(fp)) == jax_cli.load_config(str(fp))
