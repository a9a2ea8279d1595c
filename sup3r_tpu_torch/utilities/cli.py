"""CLI orchestration machinery: config -> per-node commands -> local
subprocess or SLURM submission, with JSON status tracking.

Replaces the reference's gaps/SLURM integration (reference:
sup3r/utilities/cli.py:38-373) with a self-contained jobstore: a
``.status.json`` per run directory records submitted/running/
successful/failed states and enables incremental pipeline restarts.
The port's copy of ``sup3r_tpu/utilities/cli.py``: the store's keys,
job names and states are the JAX package's, so either package reads a
run directory the other wrote. ``node_command`` builds the shell
command of a node: this interpreter, with the directory that holds
``sup3r_tpu_torch`` in front of ``PYTHONPATH``, so a node imports the
port from any working directory.
"""

import json
import logging
import os
import shlex
import subprocess
import sys
import time

logger = logging.getLogger(__name__)

STATUS_FILE = '.status.json'

#: Store format version. v2 = module keys ``module#cfghash`` and job
#: names ``module#cfghash_cfgtag_i``. Unversioned (legacy) stores used
#: plain ``module`` / ``module-{idx}`` keys with ``..._{i}`` job names;
#: they are read through :meth:`Status._legacy_lookup` so old runs
#: still skip previously successful jobs (parity with gaps Status
#: stability, reference: sup3r/utilities/cli.py:214-267).
STATUS_VERSION = 2


def init_node_logger(log_file=None, log_level='INFO', node_index=None,
                     rank=None):
    """Per-node log initialization for module subprocesses: attach a
    FileHandler + console handler on the sup3r_tpu_torch logger tree
    (replaces the reference's gaps ``init_logger`` per-node log files,
    reference: sup3r/utilities/cli.py:38-120). The pattern may contain
    ``{node_index}`` (else ``_node<i>`` is appended) and ``{rank}``: a
    rank of a node run as a group of ranks (``run_rank_group``) logs to
    its own file, the pattern's ``{rank}`` or an appended ``_rank<r>``,
    so no two processes write one file (the group's launcher passes
    ``rank='group'``, which only fills a ``{rank}``)."""
    level = getattr(logging, str(log_level).upper(), logging.INFO)
    root = logging.getLogger('sup3r_tpu_torch')
    root.setLevel(level)
    logging.basicConfig(level=level)
    if not log_file:
        return None
    base, ext = os.path.splitext(log_file)
    suffix = ''
    if node_index is not None and '{node_index}' not in log_file:
        suffix += f'_node{node_index}'
    if rank not in (None, 'group') and '{rank}' not in log_file:
        suffix += f'_rank{rank}'
    if suffix:
        log_file = base + suffix + (ext or '.log')
    log_file = log_file.replace('{node_index}', str(node_index)).replace(
        '{rank}', str(0 if rank is None else rank))
    os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                exist_ok=True)
    handler = logging.FileHandler(log_file)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(
        '%(asctime)s %(levelname)s %(name)s: %(message)s'))
    logging.getLogger().addHandler(handler)
    logger.info('Node logging to %s at %s', log_file,
                logging.getLevelName(level))
    return log_file


#: the directory that holds the ``sup3r_tpu_torch`` package
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def node_command(payload):
    """Shell command running ``payload`` (Python source) in a node
    process: this interpreter (``sys.executable``, not whatever
    ``python`` a job's shell finds) with ``PACKAGE_ROOT`` put in front
    of the inherited ``PYTHONPATH``. Nodes run with ``cwd=run_dir``, so
    without it they could import the port only where it is installed.
    The payload is one ``shlex``-quoted argument: a path in it holding
    ``$``, a backtick or quotes reaches Python as written."""
    return (f'PYTHONPATH={shlex.quote(PACKAGE_ROOT)}'
            '"${PYTHONPATH:+:$PYTHONPATH}" '
            f'{shlex.quote(sys.executable)} -c {shlex.quote(payload)}')


def run_rank_group(argv, n_ranks, timeout=None, poll_s=0.05):
    """Run ``n_ranks`` processes of ``argv``, the ranks of one node, and
    wait for all of them. Each gets torchrun's ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK`` (its index) in its environment, with the loopback
    for gloo's and NCCL's sockets unless set (the ranks share a host),
    and writes its output to a file of its own. When a rank fails the
    others are killed at once (by handle): a rank that dies before the
    rendezvous cannot leave the others waiting at it. After ``timeout``
    seconds every rank still running is killed. Returns (exit codes,
    each rank's output tail, wall s, whether the timeout stopped the
    group); a killed rank's code is negative (the signal)."""
    import tempfile

    env = dict(os.environ, WORLD_SIZE=str(n_ranks))
    env.setdefault('GLOO_SOCKET_IFNAME', 'lo')
    env.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    t0 = time.perf_counter()
    procs, outs, timed_out = [], [], False
    try:
        for rank in range(n_ranks):
            outs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                argv, stdout=outs[-1], stderr=subprocess.STDOUT,
                env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank))))
        while True:
            codes = [p.poll() for p in procs]
            if any(codes) or all(c == 0 for c in codes):
                break
            if timeout is not None and time.perf_counter() - t0 > timeout:
                timed_out = True
                break
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        codes = [p.wait() for p in procs]
        tails = []
        for out in outs:
            out.seek(0)
            tails.append(out.read()[-4000:].decode(errors='replace'))
            out.close()
    return codes, tails, time.perf_counter() - t0, timed_out


def model_device(cfg):
    """'cpu' or 'cuda': where a forward-pass node's model goes."""
    kwargs = cfg.get('model_kwargs')
    device = kwargs.get('device') if isinstance(kwargs, dict) else None
    return str(device or 'cuda').split(':')[0]


def group_command(module, cfg_fp, ranks=None, timeout=None):
    """Shell command running one node as a group of ranks: this file run
    as a script (``run_node_group``), with ``PACKAGE_ROOT`` in front of
    ``PYTHONPATH`` for the ranks. It imports the standard library only
    (torch only to count the cards when ``ranks`` is None), so the
    launcher starts at once; each rank imports the port."""
    args = [module, cfg_fp, '' if ranks is None else str(int(ranks)),
            '' if timeout is None else str(float(timeout))]
    return (f'PYTHONPATH={shlex.quote(PACKAGE_ROOT)}'
            '"${PYTHONPATH:+:$PYTHONPATH}" '
            f'{shlex.quote(sys.executable)} '
            f'{shlex.quote(os.path.abspath(__file__))} '
            + ' '.join(shlex.quote(a) for a in args))


def run_node_group(module, cfg_fp, ranks=None, timeout=None, t0=None):
    """One node as a group of ``ranks`` processes, one a device (default:
    the card count, 1 on the CPU), each running ``cli.run_node`` as one
    rank of a process group: the counterpart of a JAX node's local
    devices. ``ranks`` changes which processes run, never what is
    computed: the group's collected output is the one-process node's.
    The rendezvous is a FileStore beside the node's config, removed
    after; each rank picks the backend (``cli.run_node``). This process
    imports torch only to count the cards when ``ranks`` is None. It
    waits for the ranks (``run_rank_group``), logs a ``Group summary``
    line to the
    node's log (a ``{rank}`` in the pattern reads 'group') and raises,
    with the failed rank's output tail, when a rank fails or ``timeout``
    s pass: the node is then recorded as failed. A group of one is one
    rank-less process, as a node without a group."""
    import signal

    t0 = time.time() if t0 is None else t0
    with open(cfg_fp) as f:
        cfg = json.load(f)
    node = cfg['node_index']
    if ranks is None:
        ranks = 1
        if model_device(cfg) == 'cuda':
            import torch

            ranks = max(torch.cuda.device_count(), 1)
    if ranks == 1:
        from sup3r_tpu_torch.cli import run_node

        run_node(module, cfg_fp, t0)
        return 0
    # a terminated launcher still stops its ranks (run_rank_group's
    # finally)
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    init_node_logger(cfg.get('log_file'), cfg.get('log_level', 'INFO'),
                     node, rank='group')
    store = f'{os.path.abspath(cfg_fp)}.store.{os.getpid()}'
    payload = ('import time; t0 = time.time(); '
               'from sup3r_tpu_torch.cli import run_node; '
               f'run_node({module!r}, {cfg_fp!r}, t0, '
               f'group={"file://" + store!r})')
    try:
        codes, tails, wall_s, timed_out = run_rank_group(
            [sys.executable, '-c', payload], ranks, timeout=timeout)
    finally:
        if os.path.exists(store):
            os.remove(store)
    logger.info('Group summary: %s', json.dumps({
        'node_index': node, 'ranks': ranks, 'wall_s': wall_s,
        'exit_codes': codes, 'timed_out': timed_out}))
    if timed_out:
        raise RuntimeError(f'node {node}: its {ranks} ranks did not finish '
                           f'within {timeout} s and were stopped')
    failed = [r for r, c in enumerate(codes) if c]
    if failed:
        # the rank that failed first exited by itself; the others were
        # killed after it
        first = next((r for r in failed if codes[r] > 0), failed[0])
        raise RuntimeError(
            f'node {node}: rank {first} of {ranks} exited {codes[first]} '
            f'(exit codes {codes}); its output ends:\n{tails[first]}')
    return 0


def _legacy_module_keys(status, module):
    """Keys in an unversioned store that could be legacy spellings of
    ``module``: the bare module name (round-1 format) and indexed
    ``module-{n}`` names (repeated-module format)."""
    base = module.split('#')[0]
    out = []
    for key in status:
        if key == module or key.startswith('__'):
            continue
        if key == base:
            out.append(key)
        elif (key.startswith(base + '-')
              and key[len(base) + 1:].isdigit()):
            out.append(key)
    return out


class Status:
    """Tiny file-backed job status store."""

    def __init__(self, run_dir):
        self.run_dir = run_dir
        self.fp = os.path.join(run_dir, STATUS_FILE)

    def read(self):
        """Full status dict."""
        if os.path.exists(self.fp):
            with open(self.fp) as f:
                return json.load(f)
        return {}

    @staticmethod
    def _is_legacy(status):
        """Whether a loaded store predates the versioned key format."""
        return bool(status) and '__version__' not in status

    def _write(self, status):
        """Atomically persist the full status dict."""
        os.makedirs(self.run_dir, exist_ok=True)
        status.setdefault('__version__', STATUS_VERSION)
        tmp = self.fp + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(status, f, indent=2)
        os.replace(tmp, self.fp)

    def _legacy_lookup(self, status, module, job_name=None):
        """Resolve a (module[, job]) query against legacy key
        spellings. Returns the module's job dict or, with
        ``job_name``, that job's record or None. Consulted for
        unversioned stores and for keys recorded in ``__legacy__`` at
        migration time — new versioned keys keep the strict
        config-hash isolation.

        MULTIPLE legacy aliases (the indexed ``module-{n}`` format
        from a repeated-module pipeline) are ambiguous — the hashed
        step keys carry no index, so a success under one alias cannot
        be attributed to a specific current step. Refuse rather than
        merge: a refused lookup re-runs work (safe, chunk-level
        incremental restart dedupes it) instead of silently skipping
        a step that never ran."""
        legacy = (None if self._is_legacy(status)
                  else set(status.get('__legacy__', [])))
        keys = [k for k in _legacy_module_keys(status, module)
                if legacy is None or k in legacy]
        if len(keys) != 1:
            return {} if job_name is None else None
        merged = {}
        for key in keys:
            merged.update(status.get(key, {}))
        if job_name is None:
            return merged
        # current job names carry the module key + a config tag:
        # ``{module}_{cfgtag}_{i}``; legacy names were ``{key}_{i}``
        tail = job_name.rsplit('_', 1)[-1]
        if not tail.isdigit():
            return merged.get(job_name)
        for key in keys:
            rec = status.get(key, {}).get(f'{key}_{tail}')
            if rec is not None:
                return rec
        return None

    @staticmethod
    def _mark_legacy(status):
        """When mutating a store that predates versioning, record its
        pre-existing keys so they keep resolving as legacy aliases
        after the write stamps ``__version__``."""
        if Status._is_legacy(status):
            status['__legacy__'] = [
                k for k in status if not k.startswith('__')]

    def update(self, module, job_name, **kwargs):
        """Merge a job record."""
        status = self.read()
        self._mark_legacy(status)
        job = status.setdefault(module, {}).setdefault(job_name, {})
        job.update(kwargs)
        job['time'] = time.strftime('%Y-%m-%d %H:%M:%S')
        self._write(status)

    def clear_failed(self, module):
        """Drop a module's failed job records so a retry re-runs them
        (mirrors gaps' resubmit behavior; successful jobs keep their
        skip-on-rerun records)."""
        status = self.read()
        self._mark_legacy(status)
        jobs = status.get(module, {})
        failed = [k for k, j in jobs.items()
                  if j.get('job_status') == 'failed']
        if not failed:
            return
        for k in failed:
            del jobs[k]
        self._write(status)

    def job_status(self, module, job_name):
        """'successful' | 'failed' | 'running' | None."""
        status = self.read()
        rec = status.get(module, {}).get(job_name)
        if rec is None:
            rec = self._legacy_lookup(status, module, job_name)
        return (rec or {}).get('job_status')

    def module_successful(self, module):
        """True if the module has jobs and all are successful."""
        status = self.read()
        jobs = status.get(module, {}) or self._legacy_lookup(
            status, module)
        return bool(jobs) and all(
            j.get('job_status') == 'successful' for j in jobs.values())

    def module_failed(self, module):
        """True if any job of the module is failed."""
        status = self.read()
        jobs = status.get(module, {}) or self._legacy_lookup(
            status, module)
        return any(j.get('job_status') == 'failed'
                   for j in jobs.values())

    def poll(self, module=None, squeue_fn=None, sacct_fn=None):
        """Transition submitted/running SLURM jobs to their real state
        (reference tracks job transitions via gaps Status +
        hardware queries, sup3r/utilities/cli.py:214-267).

        Order of evidence per job: (1) the exit-code sentinel file the
        sbatch script writes on completion (works on any shared
        filesystem, no scheduler tools needed), (2) ``squeue`` for
        PENDING/RUNNING, (3) ``sacct`` for terminal states. Jobs with
        no evidence keep their current state. ``squeue_fn``/
        ``sacct_fn`` are injectable ``job_id -> str | None`` hooks for
        testing."""
        squeue_fn = squeue_fn or _squeue_state
        sacct_fn = sacct_fn or _sacct_state
        status = self.read()
        if module is not None:
            # include legacy alias keys: in-flight jobs recorded under
            # old spellings must still transition, or an upgraded
            # pipeline would double-submit on top of running SLURM
            # jobs (round-3 review finding)
            legacy = (None if self._is_legacy(status)
                      else set(status.get('__legacy__', [])))
            modules = [module] + [
                k for k in _legacy_module_keys(status, module)
                if legacy is None or k in legacy]
        else:
            modules = [m for m in status if not m.startswith('__')]
        for mod in modules:
            for job_name, job in status.get(mod, {}).items():
                state = job.get('job_status')
                if state not in ('submitted', 'running'):
                    continue
                exit_fp = job.get('exit_file')
                if exit_fp and os.path.exists(exit_fp):
                    with open(exit_fp) as f:
                        code = f.read().strip()
                    new = ('successful' if code == '0' else 'failed')
                    self.update(mod, job_name, job_status=new,
                                exit_code=code)
                    continue
                job_id = job.get('job_id')
                if not job_id:
                    continue
                q = squeue_fn(job_id)
                if q is not None:
                    new = 'running' if q == 'RUNNING' else 'submitted'
                    if new != state:
                        self.update(mod, job_name, job_status=new)
                    continue
                s = sacct_fn(job_id)
                if s is None:
                    continue
                if s.startswith('COMPLETED'):
                    self.update(mod, job_name, job_status='successful')
                elif s.startswith(('FAILED', 'CANCELLED', 'TIMEOUT',
                                   'OUT_OF_MEMORY', 'NODE_FAIL')):
                    self.update(mod, job_name, job_status='failed',
                                slurm_state=s)
                elif s.startswith('RUNNING') and state != 'running':
                    self.update(mod, job_name, job_status='running')
        return self.read()


def _squeue_state(job_id):
    """PENDING/RUNNING/... from squeue, or None if not queued /
    squeue unavailable."""
    try:
        out = subprocess.run(
            ['squeue', '-j', str(job_id), '-h', '-o', '%T'],
            capture_output=True, text=True, timeout=30)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    state = out.stdout.strip().split('\n')[0].strip()
    return state or None


def _sacct_state(job_id):
    """Terminal state from sacct, or None if unavailable."""
    try:
        out = subprocess.run(
            ['sacct', '-j', str(job_id), '-n', '-X', '-o', 'State'],
            capture_output=True, text=True, timeout=30)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    state = out.stdout.strip().split('\n')[0].strip()
    return state or None


class BaseCLI:
    """Shared from_config flow for all module CLIs."""

    @staticmethod
    def run_local(cmd, module, job_name, run_dir):
        """Run a node command as a local subprocess, recording status."""
        status = Status(run_dir)
        if status.job_status(module, job_name) == 'successful':
            logger.info('Job %s/%s already successful; skipping.',
                        module, job_name)
            return 0
        status.update(module, job_name, job_status='running')
        # run in the project dir so config-relative paths resolve
        # against it (gaps runs jobs from the project directory)
        result = subprocess.run(cmd, shell=True, capture_output=True,
                                text=True, cwd=run_dir or None)
        ok = result.returncode == 0
        status.update(module, job_name,
                      job_status='successful' if ok else 'failed',
                      stderr=result.stderr[-2000:] if not ok else '')
        if not ok:
            logger.error('Job %s/%s failed:\n%s', module, job_name,
                         result.stderr[-2000:])
        return result.returncode

    @staticmethod
    def run_slurm(cmd, module, job_name, run_dir, alloc=None,
                  walltime=4, memory=None, feature=None,
                  sbatch='sbatch'):
        """Submit a node command via sbatch. The generated script
        writes an exit-code sentinel on completion so Status.poll can
        transition submitted -> successful/failed from any node with
        the shared filesystem, even without squeue/sacct. ``sbatch``
        is injectable for tests."""
        status = Status(run_dir)
        # transition dead jobs first (exit sentinel / squeue / sacct)
        # so only genuinely live submissions block a resubmit
        status.poll(module)
        state = status.job_status(module, job_name)
        if state == 'successful':
            logger.info('Job %s/%s already successful; skipping.',
                        module, job_name)
            return 0
        if state in ('submitted', 'running'):
            # resubmitting on top of a live SLURM job would double-
            # write its chunk outputs (reference refuses to resubmit
            # any non-failed submitted job, utilities/cli.py:229-233)
            logger.info('Job %s/%s has status %r; not resubmitting.',
                        module, job_name, state)
            return 0
        exit_fp = os.path.abspath(
            os.path.join(run_dir, f'.{job_name}.exit'))
        if os.path.exists(exit_fp):
            os.remove(exit_fp)
        script = (f'#!/bin/bash\n#SBATCH --job-name={job_name}\n'
                  f'#SBATCH --time={int(float(walltime) * 60)}\n')
        if alloc:
            script += f'#SBATCH --account={alloc}\n'
        if memory:
            script += f'#SBATCH --mem={memory}\n'
        if feature:
            script += f'#SBATCH {feature}\n'
        # run from the project dir so config-relative paths resolve
        # against it (gaps runs jobs from the project directory)
        script += f'cd {shlex.quote(os.path.abspath(run_dir))}\n'
        # subshell so the sentinel still writes if the command exits
        # the shell (or the job script is killed mid-command by a
        # signal bash forwards)
        script += (f'(\n{cmd}\n)\nrc=$?\n'
                   f'echo $rc > {shlex.quote(exit_fp)}\nexit $rc\n')
        fp = os.path.join(run_dir, f'{job_name}.sbatch')
        os.makedirs(run_dir, exist_ok=True)
        with open(fp, 'w') as f:
            f.write(script)
        try:
            out = subprocess.run([sbatch, fp], capture_output=True,
                                 text=True)
            rc, stdout, stderr = (out.returncode, out.stdout,
                                  out.stderr)
        except FileNotFoundError as e:
            rc, stdout, stderr = 127, '', f'{sbatch}: {e}'
        # "Submitted batch job <id>"
        job_id = None
        tokens = stdout.strip().split()
        if tokens and tokens[-1].isdigit():
            job_id = tokens[-1]
        status.update(module, job_name,
                      job_status='submitted' if rc == 0 else 'failed',
                      job_id=job_id, exit_file=exit_fp,
                      sbatch_out=stdout.strip(),
                      stderr='' if rc == 0 else stderr[-2000:])
        return rc

    @classmethod
    def kickoff_jobs(cls, module, cmds, config, job_tag=None):
        """Dispatch one command per node by execution_control.
        ``job_tag`` (e.g. a config hash) disambiguates job names so
        two DIFFERENT configs sharing a run_dir never skip each
        other's work via the already-successful check."""
        run_dir = config.get('run_dir', './')
        exec_ctrl = config.get('execution_control',
                               {'option': 'local'})
        option = exec_ctrl.get('option', 'local')
        codes = []
        for i, cmd in enumerate(cmds):
            job_name = (f'{module}_{job_tag}_{i}' if job_tag
                        else f'{module}_{i}')
            if option == 'local':
                codes.append(cls.run_local(cmd, module, job_name,
                                           run_dir))
            else:
                kwargs = {k: v for k, v in exec_ctrl.items()
                          if k in ('alloc', 'walltime', 'memory',
                                   'feature', 'sbatch')}
                codes.append(cls.run_slurm(cmd, module, job_name,
                                           run_dir, **kwargs))
        return codes


def load_config(config_file):
    """Read a JSON config file."""
    with open(config_file) as f:
        return json.load(f)


if __name__ == '__main__':
    # a node run as a group of ranks (``group_command``): module, config
    # file, ranks and timeout ('' for the defaults). The package, not
    # this file's directory, goes on the path.
    _t0 = time.time()
    sys.path[0] = PACKAGE_ROOT
    _module, _cfg_fp, _ranks, _timeout = sys.argv[1:5]
    sys.exit(run_node_group(_module, _cfg_fp,
                            int(_ranks) if _ranks else None,
                            float(_timeout) if _timeout else None, _t0))
