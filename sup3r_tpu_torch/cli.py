"""sup3r-tpu-torch command line interface.

Reference parity: sup3r/cli.py:21-461 (forward-pass, solar, bias-calc,
data-collect, qa, pipeline, batch commands driven by JSON configs with
an execution_control block). The port's copy of ``sup3r_tpu/cli.py``
with the same commands, options, config keys, job identities and
status store, on ``argparse``:

    python -m sup3r_tpu_torch.cli -c config_pipeline.json pipeline --monitor

It runs as a module where the port is importable (the repo root, or an
installed ``sup3r-tpu-torch`` console script), and from any directory as
a script, ``python <repo>/sup3r_tpu_torch/cli.py -c ...``.
``main(argv)`` takes an argument list and returns the exit code. Each
module command writes one JSON config per node and runs the node as
its own process (``utilities.cli.node_command``): this interpreter with
the port on its ``PYTHONPATH``. A node's device comes from its config
(``model_kwargs['device']`` for forward-pass, ``device`` for qa and
bias-calc): the card by default, and a node with no card raises. A
forward-pass node with ``use_mesh`` (or ``device_batch_size='auto'``)
runs as a group of ranks, one process a device
(``execution_control['ranks_per_node']``, default the card count;
``utilities.cli.run_node_group``), with one status entry for the node.
"""

import os
import sys

if __name__ == '__main__' and not __package__:
    # run as a script: import the package from beside this file rather
    # than the package directory itself
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

import argparse  # noqa: E402
import hashlib  # noqa: E402
import inspect  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from contextlib import contextmanager  # noqa: E402

import numpy as np  # noqa: E402

import sup3r_tpu_torch  # noqa: E402
from sup3r_tpu_torch.utilities.cli import (  # noqa: E402
    PACKAGE_ROOT,
    BaseCLI,
    Status,
    group_command,
    init_node_logger,
    load_config,
    model_device,
    node_command,
)

logger = logging.getLogger(__name__)


class CliError(Exception):
    """A command failed: ``main`` prints it and exits 1."""


def _cfg_tag(run_cfg):
    """Stable short hash of a run config — job names carry it so two
    different configs sharing a run_dir never skip each other's jobs
    through the already-successful check."""
    blob = json.dumps(run_cfg, sort_keys=True, default=str)
    return hashlib.md5(blob.encode()).hexdigest()[:6]


def _group_node(config, ranks_per_node):
    """Whether a forward-pass node may run as a group of ranks (one
    process a device, ``utilities.cli.run_node_group``): its chunks are
    shared out with ``use_mesh`` (``True``: rank i of n takes every n-th
    chunk; ``'spatial'``: every rank its s1 rows of every chunk), and with
    ``device_batch_size='auto'`` the ranks take the first rank's plan
    (``ForwardPass._resolve_auto_batch``). Raises when
    ``ranks_per_node`` asks for more than one rank and neither holds:
    each rank would run every chunk."""
    shared = (bool(config.get('use_mesh'))
              or config.get('device_batch_size') == 'auto')
    if ranks_per_node is not None:
        if int(ranks_per_node) < 1:
            raise ValueError(f'ranks_per_node={ranks_per_node} must be '
                             '>= 1')
        if int(ranks_per_node) > 1 and not shared:
            raise ValueError(
                f'ranks_per_node={ranks_per_node} without use_mesh: each '
                "of the node's ranks would run every chunk. Set use_mesh "
                '(True or "spatial") or device_batch_size="auto", or drop '
                'ranks_per_node')
    return shared


def _node_cmd(module, config, node_index, run_dir,
              status_module=None, execution_control=None):
    """Shell command running one node of a module, reading its config
    from a file (robust to shell quoting; analogous to the reference's
    get_node_cmd strings, reference:
    sup3r/pipeline/forward_pass.py:339-382). ``status_module``
    disambiguates node-config file names when the same module appears
    multiple times in one pipeline. A forward-pass node whose chunks are
    shared out (``_group_node``) runs as a group of ranks
    (``utilities.cli.run_node_group``):
    ``execution_control['ranks_per_node']`` of them (default: the node's
    card count, 1 on the CPU), stopped after
    ``execution_control['ranks_timeout']`` s where that is set."""
    exec_ctrl = execution_control or {}
    cfg = dict(config)
    cfg['node_index'] = node_index
    cfg.pop('execution_control', None)
    cfg.pop('run_dir', None)
    ranks = exec_ctrl.get('ranks_per_node')
    group = module == 'forward-pass' and _group_node(cfg, ranks)
    os.makedirs(run_dir, exist_ok=True)
    name = (status_module or module).replace('#', '-')
    cfg_fp = os.path.join(
        run_dir, f'.{name}_{_cfg_tag(config)}_node{node_index}.json')
    with open(cfg_fp, 'w') as f:
        json.dump(cfg, f)
    if group:
        return group_command(module, cfg_fp, ranks,
                             exec_ctrl.get('ranks_timeout'))
    # the clock starts before the imports, so the node's start-up time
    # covers them
    payload = ('import time; t0 = time.time(); '
               'from sup3r_tpu_torch.cli import run_node; '
               f'run_node({module!r}, {cfg_fp!r}, t0)')
    return node_command(payload)


def run_node(module, cfg_fp, t0=None, group=None):
    """One node of ``module`` on the config ``_node_cmd`` wrote. The
    ``log_file`` / ``log_level`` keys go to the node's logger (the
    pattern may contain ``{node_index}`` and ``{rank}``), never to the
    module classes. A forward-pass node logs a ``Node summary`` JSON
    line: its rank, start-up seconds (process start to the strategy
    ready on its device; of them, ``import_s`` to the port's pipeline
    imported), run seconds and the hand kernels' launches.

    ``group`` (the rendezvous's init method) makes this process one rank
    of a node's group (``utilities.cli.run_node_group``; ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` in the environment): it joins the
    process group before the strategy loads the model, on the card
    ``LOCAL_RANK`` names modulo the card count, over NCCL when every
    rank has a card of its own and gloo when ranks share one or run on
    the CPU, and leaves it with the other ranks."""
    t0 = time.time() if t0 is None else t0
    with open(cfg_fp) as f:
        cfg = json.load(f)
    node = cfg.pop('node_index')
    rank = world = None
    if group is not None:
        rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    init_node_logger(cfg.pop('log_file', None),
                     cfg.pop('log_level', 'INFO'), node, rank=rank)
    if group is None:
        return _run_module(module, cfg, node, t0, rank, world)
    import torch
    import torch.distributed as dist

    from sup3r_tpu_torch.parallel.mesh import init_multihost

    on_cpu = model_device(cfg) == 'cpu'
    cards = 0 if on_cpu else torch.cuda.device_count()
    init_multihost(group, world, rank,
                   backend='nccl' if 0 < world <= cards else 'gloo',
                   local_device_ids=None if on_cpu
                   else [int(os.environ.get('LOCAL_RANK', rank))])
    _run_module(module, cfg, node, t0, rank, world)
    # the ranks leave together: one that exits while another still
    # talks to it aborts that one
    dist.barrier()
    dist.destroy_process_group()


def _run_module(module, cfg, node, t0, rank=None, world=None):
    """Run ``module`` on a node's config (``run_node``)."""
    if module == 'forward-pass':
        from sup3r_tpu_torch.ops.kernels import (
            reflect_conv_cf,
            small_reflect_conv_cf,
        )
        from sup3r_tpu_torch.pipeline import (
            ForwardPass,
            ForwardPassStrategy,
        )

        import torch.distributed

        import_s = time.time() - t0
        strategy = ForwardPassStrategy(**cfg)
        startup_s = time.time() - t0
        ForwardPass.run(strategy, node)
        logger.info('Node summary: %s', json.dumps({
            'node_index': node, 'rank': rank, 'ranks': world,
            'backend': (torch.distributed.get_backend()
                        if torch.distributed.is_initialized() else None),
            'startup_s': startup_s,
            'import_s': import_s,
            'run_s': time.time() - t0 - startup_s,
            'launches': {
                'small_reflect_conv': small_reflect_conv_cf.launches,
                'reflect_conv': reflect_conv_cf.launches}}))
    elif module == 'solar':
        from sup3r_tpu_torch.solar import Solar

        Solar.run_temporal_chunks(node_index=node, **cfg)
    elif module == 'data-collect':
        from sup3r_tpu_torch.postprocessing.collectors import (
            CollectorH5,
            CollectorNC,
        )

        cls = (CollectorH5 if str(cfg.get('out_file')).endswith('.h5')
               else CollectorNC)
        cls.collect(**cfg)
    elif module == 'qa':
        from sup3r_tpu_torch.qa import Sup3rQa

        Sup3rQa(**cfg).run()
    else:
        raise ValueError(f'Unknown node module {module!r}')


def _get_config(config_file):
    if config_file is None:
        raise CliError('A config file is required: python -m '
                       'sup3r_tpu_torch.cli -c config.json <command>')
    config = load_config(config_file)
    config.setdefault('run_dir',
                      os.path.dirname(os.path.abspath(config_file)))
    # node jobs run with cwd=run_dir; a relative run_dir would
    # double-resolve the embedded node-config paths
    config['run_dir'] = os.path.abspath(config['run_dir'])
    return config


@contextmanager
def _in_dir(path):
    """Run the parent-process part of a module command from the
    project dir, so config-relative paths (out_pattern, cache dirs)
    resolve exactly as they do in the node subprocesses (which run
    with cwd=run_dir)."""
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _run_cfg(config, *drop):
    return {k: v for k, v in config.items()
            if k not in ('execution_control', 'run_dir', *drop)}


def _kickoff(module, status_module, run_cfg, config, n_nodes, what):
    cmds = [_node_cmd(module, run_cfg, i, config['run_dir'],
                      status_module=status_module,
                      execution_control=config.get('execution_control'))
            for i in range(n_nodes)]
    codes = BaseCLI.kickoff_jobs(status_module, cmds, config,
                                 job_tag=_cfg_tag(run_cfg))
    if any(codes):
        raise CliError(what)


def forward_pass(config_file, status_module=None):
    """Run chunked forward passes from a config."""
    from sup3r_tpu_torch.pipeline import ForwardPassStrategy

    config = _get_config(config_file)
    run_cfg = _run_cfg(config, 'max_nodes_cli')
    with _in_dir(config['run_dir']):
        # head_node: plan node_chunks without the exo/bias preflight
        # the worker nodes will do themselves (log_file/log_level are
        # node-runner keys, consumed by run_node's log init)
        strategy = ForwardPassStrategy(
            **{k: v for k, v in run_cfg.items()
               if k not in ('log_file', 'log_level')},
            head_node=True)
        n_nodes = len(strategy.node_chunks)
        # freeze the node plan HERE and ship it to every node: with
        # redistribute_chunks each node re-deriving the plan at its
        # own (staggered) start time would see a different set of
        # finished chunks and orphan work (strategy.node_chunks_plan)
        run_cfg = {**run_cfg, 'node_chunks_plan': [
            [int(x) for x in c] for c in strategy.node_chunks]}
        # ship expensive head-computed preflight artifacts to the
        # nodes (the chunked_io NCforCC per-pixel clearsky scale
        # raster is a full NSRDB scan — workers must not redo it N
        # times). Arrays go through a run_dir .npy side file since
        # node configs are JSON.
        scale = getattr(strategy, '_chunk_ihk', {}).get(
            'clearsky_scale')
        if scale is not None:
            if isinstance(scale, np.ndarray):
                scale_fp = os.path.abspath(os.path.join(
                    config['run_dir'],
                    f'.clearsky_scale_{_cfg_tag(run_cfg)}.npy'))
                np.save(scale_fp, scale)
                scale = scale_fp
            ihk = dict(run_cfg.get('input_handler_kwargs') or {})
            ihk['clearsky_scale'] = scale
            run_cfg = {**run_cfg, 'input_handler_kwargs': ihk}
    _kickoff('forward-pass', status_module or 'forward-pass', run_cfg,
             config, n_nodes, 'Some forward-pass jobs failed')


def solar(config_file, status_module=None):
    """Run the solar irradiance module from a config. ``max_nodes``
    fans temporal chunks out over that many jobs (reference:
    sup3r/solar/solar.py:584 one job per temporal-chunk split)."""
    config = _get_config(config_file)
    run_cfg = _run_cfg(config)
    _kickoff('solar', status_module or 'solar', run_cfg, config,
             int(run_cfg.get('max_nodes') or 1), 'Solar job failed')


def bias_calc(config_file, status_module=None):
    """Run bias calculations: config has a list of 'jobs' each with
    'bias_calc_class' + kwargs. A config-level ``device`` reaches the
    calculations that take one (QDM, PresRat) unless a job sets its
    own."""
    import sup3r_tpu_torch.bias as bias_mod

    config = _get_config(config_file)
    status = Status(config['run_dir'])
    module = status_module or 'bias-calc'
    for i, job in enumerate(config['jobs']):
        job = dict(job)
        cls = getattr(bias_mod, job.pop('bias_calc_class'))
        fp_out = job.pop('fp_out', None)
        run_kwargs = job.pop('run_kwargs', {})
        if 'device' in config and (
                'device' in inspect.signature(cls).parameters):
            job.setdefault('device', config['device'])
        status.update(module, f'bias_calc_{i}', job_status='running')
        try:
            cls(**job).run(fp_out=fp_out, **run_kwargs)
        except Exception as e:
            status.update(module, f'bias_calc_{i}',
                          job_status='failed', error=str(e))
            raise
        status.update(module, f'bias_calc_{i}', job_status='successful')


def data_collect(config_file, status_module=None):
    """Collect chunked output files into one file."""
    config = _get_config(config_file)
    _kickoff('data-collect', status_module or 'data-collect',
             _run_cfg(config), config, 1, 'Collection failed')


def qa(config_file, status_module=None):
    """Run output QA from a config."""
    config = _get_config(config_file)
    _kickoff('qa', status_module or 'qa', _run_cfg(config), config, 1,
             'QA failed')


COMMANDS = {'forward-pass': forward_pass, 'solar': solar,
            'bias-calc': bias_calc, 'data-collect': data_collect,
            'qa': qa}


def import_model(reference_dir, out_dir, lr_shape=None, device='cuda'):
    """Convert a reference (NREL sup3r / phygnn TF) model checkpoint
    directory into a model directory usable by every forward-pass /
    pipeline command. Multi-step bundles (a directory of model_step_* /
    per-step subdirectories, as NREL releases them) are converted step
    by step into matching subdirectories."""
    from sup3r_tpu_torch.utilities.port import load_reference_gan

    shape = (tuple(int(x) for x in lr_shape.split(','))
             if lr_shape else None)
    steps = sorted(
        d for d in os.listdir(reference_dir)
        if os.path.isfile(os.path.join(reference_dir, d,
                                       'model_params.json')))
    if steps and not os.path.isfile(
            os.path.join(reference_dir, 'model_params.json')):
        for step in steps:
            model = load_reference_gan(
                os.path.join(reference_dir, step), lr_shape=shape,
                device=device)
            model.save(os.path.join(out_dir, step))
            print(f'Imported step {step} '
                  f'({model.s_enhance}x/{model.t_enhance}x)')
        print(f'Imported {len(steps)}-step bundle '
              f'{reference_dir} -> {out_dir}')
        return
    model = load_reference_gan(reference_dir, lr_shape=shape,
                               device=device)
    model.save(out_dir)
    print(f'Imported {reference_dir} -> {out_dir} '
          f'({model.s_enhance}x spatial / {model.t_enhance}x temporal)')


def _parse_step(step):
    """(module, cfg_file) from either step spelling: the plain
    ``{module: cfg}`` form, or the reference's named form
    ``{'<any-name>': cfg, 'command': module}`` (reference:
    examples/sup3rcc/run_configs/solar/config_pipeline.json)."""
    step = dict(step)
    module = step.pop('command', None)
    (name, cfg_file), = step.items()
    return module or name, cfg_file


def _step_info(step, run_dir):
    """(module, abs cfg path, status key, status dir). Step identity is
    module + config hash: repeated modules (the sup3rwind two-fwp
    chain), edited configs, and reordered steps all resolve to the
    right skip/rerun behavior. The status dir replicates what the
    invoked command's ``_get_config`` computes (explicit 'run_dir' key,
    else the config's own directory): the step's node jobs record
    status THERE, so the monitor polls there too."""
    module, cfg_file = _parse_step(step)
    fp = (cfg_file if os.path.isabs(cfg_file)
          else os.path.join(run_dir, cfg_file))
    fp = os.path.abspath(fp)
    try:
        step_cfg = load_config(fp)
        tag = _cfg_tag(step_cfg)
    except FileNotFoundError:
        step_cfg = {}
        tag = _cfg_tag({'file': cfg_file})
    step_dir = os.path.abspath(step_cfg.get('run_dir')
                               or os.path.dirname(fp))
    return module, fp, f'{module}#{tag}', step_dir


def _pipeline_background(config_file, run_dir):
    """Detach a ``pipeline --monitor`` process (reference: sup3r
    pipeline --background); its pid goes to .pipeline_monitor.pid."""
    cfg_fp = os.path.abspath(config_file)
    log_fp = os.path.join(run_dir, 'pipeline_monitor.log')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (PACKAGE_ROOT, env.get('PYTHONPATH')) if p)
    with open(log_fp, 'a') as log:
        proc = subprocess.Popen(
            [sys.executable, '-m', 'sup3r_tpu_torch.cli', '-c', cfg_fp,
             'pipeline', '--monitor'],
            stdout=log, stderr=log, start_new_session=True, cwd=run_dir,
            env=env)
    with open(os.path.join(run_dir, '.pipeline_monitor.pid'), 'w') as f:
        f.write(str(proc.pid))
    logger.info('Detached pipeline monitor pid %d (log: %s)', proc.pid,
                log_fp)


def _pipeline_cancel(config, run_dir):
    """Cancel every non-terminal job recorded for this project —
    including step configs whose status lives in their own directory
    (reference: gaps Pipeline.cancel_all)."""
    n = 0
    status_dirs = [run_dir]
    for step in config.get('pipeline', []):
        step_dir = _step_info(step, run_dir)[3]
        if step_dir not in status_dirs:
            status_dirs.append(step_dir)
    for step_status in map(Status, status_dirs):
        for module, jobs in step_status.read().items():
            if module.startswith('__'):
                continue
            for job_name, job in jobs.items():
                if job.get('job_status') not in ('submitted', 'running'):
                    continue
                job_id = job.get('job_id')
                if job_id:
                    try:
                        res = subprocess.run(
                            ['scancel', str(job_id)],
                            capture_output=True, text=True, timeout=30)
                        if res.returncode != 0:
                            # the SLURM job may still be running — do
                            # NOT mark it canceled (a resubmit would
                            # double-write its chunks)
                            logger.error(
                                'scancel %s failed (rc=%s): %s — '
                                'leaving job status unchanged',
                                job_id, res.returncode,
                                res.stderr.strip()[-500:])
                            continue
                    except FileNotFoundError:
                        logger.warning('scancel not available; only '
                                       'marking job %s canceled', job_id)
                step_status.update(module, job_name,
                                   job_status='canceled')
                n += 1
    logger.info('Canceled %d pending/running job(s) across %s', n,
                status_dirs)


def pipeline(config_file, monitor=False, cancel=False, background=False):
    """Run a multi-step pipeline config: {'pipeline': [{'forward-pass':
    'cfg.json'}, {'data-collect': 'cfg.json'}, ...]} — each step runs
    when its predecessor has succeeded (incremental restart via the
    status file)."""
    config = _get_config(config_file)
    run_dir = config['run_dir']
    if background:
        _pipeline_background(config_file, run_dir)
        return
    if cancel:
        _pipeline_cancel(config, run_dir)
        return
    poll_interval = float(config.get('poll_interval', 10))
    for step in config['pipeline']:
        module, step_cfg_fp, skey, step_dir = _step_info(step, run_dir)
        # the step command records its node jobs in ITS config's run
        # dir (see _get_config) — poll the same store, or steps whose
        # config lives in a subdirectory never look successful
        step_status = Status(step_dir)
        step_status.poll(skey)  # pick up finished SLURM jobs first
        if step_status.module_successful(skey):
            logger.info('Pipeline step "%s" already successful.', skey)
            continue
        logger.info('Running pipeline step "%s"', skey)
        t0 = time.perf_counter()
        step_status.clear_failed(skey)  # retry failed jobs of this step
        try:
            COMMANDS[module](step_cfg_fp, status_module=skey)
        except Exception as e:
            # setup failures (bad config, missing model dir) happen
            # before any node job records status — record them so
            # `.status.json` always explains why the pipeline stopped
            step_status.update(skey, f'{skey}_setup', job_status='failed',
                               stderr=str(e)[-2000:])
            raise CliError(f'Pipeline step "{skey}" failed during '
                           f'setup: {e}') from e
        if not monitor:
            break
        # SLURM steps return after sbatch; poll until terminal so the
        # next step only starts on success (reference: gaps Pipeline
        # monitoring, sup3r/utilities/cli.py:214-267)
        while True:
            step_status.poll(skey)
            if step_status.module_successful(skey):
                break
            if step_status.module_failed(skey):
                raise CliError(f'Pipeline step "{skey}" failed; see '
                               f'{step_status.fp}')
            pending = any(
                j.get('job_status') in ('submitted', 'running')
                for j in step_status.read().get(skey, {}).values())
            if not pending:
                raise CliError(f'Pipeline step "{skey}" did not '
                               f'complete; see {step_status.fp}')
            time.sleep(poll_interval)
        logger.info('Pipeline step "%s" finished in %.3f s', skey,
                    time.perf_counter() - t0)


def _batch_combos(config):
    """(job dir, files, {arg: value}) of each permutation of a batch
    config's 'sets' (reference: gaps BatchJob semantics)."""
    for batch_set in config['sets']:
        args = batch_set['args']
        keys = list(args)
        for combo in itertools.product(*[args[k] for k in keys]):
            tag = '_'.join(f'{k}_{v}' for k, v in zip(keys, combo))
            yield (os.path.join(config['run_dir'], f'batch_{tag}'),
                   batch_set['files'], dict(zip(keys, combo)))


def batch(config_file, dry_run=False, cancel=False, delete=False):
    """Permutation batching: config has 'sets' of [{'args': {k:
    [v1, v2]}, 'files': [...]}] expanded into per-permutation project
    directories (reference: gaps BatchJob semantics)."""
    config = _get_config(config_file)
    run_dir = config['run_dir']
    if cancel or delete:
        for job_dir, _, _ in _batch_combos(config):
            if not os.path.isdir(job_dir):
                continue
            pipeline_fp = os.path.join(job_dir, 'config_pipeline.json')
            if cancel and os.path.exists(pipeline_fp):
                pipeline(pipeline_fp, cancel=True)
            if delete:
                shutil.rmtree(job_dir)
                logger.info('Deleted batch dir %s', job_dir)
        return
    for job_dir, files, values in _batch_combos(config):
        os.makedirs(job_dir, exist_ok=True)
        for fp in files:
            src = fp if os.path.isabs(fp) else os.path.join(run_dir, fp)
            with open(src) as f:
                cfg = json.load(f)
            # only replace keys the config actually has (gaps BatchJob
            # semantics) — a fwp-only arg must not leak into the
            # collect config as an unexpected kwarg
            cfg.update({k: v for k, v in values.items() if k in cfg})
            with open(os.path.join(job_dir, os.path.basename(fp)),
                      'w') as f:
                json.dump(cfg, f, indent=2)
        logger.info('Created batch dir %s', job_dir)
        pipeline_fp = os.path.join(job_dir, 'config_pipeline.json')
        if not dry_run and os.path.exists(pipeline_fp):
            pipeline(pipeline_fp, monitor=True)


def build_parser():
    """The argument parser: ``-c/--config_file`` and ``-v`` before the
    command, as in the JAX package's click group."""
    parser = argparse.ArgumentParser(
        prog='sup3r-tpu-torch',
        description='sup3r-tpu-torch: super resolution for renewable '
                    'resource data, on PyTorch and CUDA.')
    parser.add_argument('--version', action='version',
                        version=sup3r_tpu_torch.__version__)
    parser.add_argument('-c', '--config_file', default=None,
                        help='JSON config file for the requested command.')
    parser.add_argument('-v', '--verbose', action='store_true')
    sub = parser.add_subparsers(dest='command', required=True)
    for name, fn in COMMANDS.items():
        sub.add_parser(name, help=fn.__doc__.split('.')[0] + '.')
    imp = sub.add_parser('import-model', help=import_model.__doc__.split(
        '.')[0] + '.')
    imp.add_argument('reference_dir')
    imp.add_argument('out_dir')
    imp.add_argument('--lr-shape', default=None,
                     help='Comma-separated one-sample input shape, e.g. '
                          '"1,8,8,8,2" (inferred from the meta if omitted).')
    imp.add_argument('--device', default='cuda',
                     help='Device the model is built on (default: the '
                          'card).')
    pipe = sub.add_parser('pipeline',
                          help=pipeline.__doc__.split('.')[0] + '.')
    pipe.add_argument('--monitor', action='store_true',
                      help='Run all steps to completion in order.')
    pipe.add_argument('--cancel', action='store_true',
                      help='scancel pending/running SLURM jobs of this '
                           'pipeline and mark them canceled.')
    pipe.add_argument('--background', action='store_true',
                      help='Detach a `pipeline --monitor` process and '
                           'return immediately; pid written to '
                           '.pipeline_monitor.pid in the run dir.')
    bat = sub.add_parser('batch', help=batch.__doc__.split('.')[0] + '.')
    bat.add_argument('--dry-run', action='store_true',
                     help='Only create the batch project directories.')
    bat.add_argument('--cancel', action='store_true',
                     help='Cancel pending/running jobs of every batch '
                          'sub-pipeline.')
    bat.add_argument('--delete', action='store_true',
                     help='Delete all batch job sub-directories created '
                          'from this config.')
    return parser


def main(argv=None):
    """Run one command; returns the exit code (1 when it fails)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config_file is not None and not os.path.exists(
            args.config_file):
        parser.error(f'config file {args.config_file!r} does not exist')
    logging.basicConfig(level=logging.DEBUG if args.verbose
                        else logging.INFO)
    try:
        if args.command == 'import-model':
            import_model(args.reference_dir, args.out_dir, args.lr_shape,
                         args.device)
        elif args.command == 'pipeline':
            pipeline(args.config_file, monitor=args.monitor,
                     cancel=args.cancel, background=args.background)
        elif args.command == 'batch':
            batch(args.config_file, dry_run=args.dry_run,
                  cancel=args.cancel, delete=args.delete)
        else:
            COMMANDS[args.command](args.config_file)
    except CliError as e:
        print(f'Error: {e}', file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
