"""The harness on the CPU: cells, configurations and metrics found by
name from files; the guard against JAX; the result line; the refusal
without a card; and ``correct`` coming out false when the timed path is
broken underneath a run (at small sizes, past the look for a card)."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness
from portbench.run import finish
from portbench.tests import tiny

NEW_METRIC = '''"""fwp.chunks_per_pass: chunks a pass."""


def read(record):
    if record.get('kind') != 'fwp' or not record['passes']:
        return None
    return record['chunks'] / record['passes']
'''


def digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            if '__pycache__' not in path:
                with open(path, 'rb') as fh:
                    out[path] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_cell_config_and_metric_are_files(tmp_path):
    """A cell, a configuration and a metric added as files (and entries)
    run without a change to any file that was there."""
    root = tiny.make(tmp_path)
    pb = root / 'portbench'
    before = digests(pb)
    config = json.loads((pb / 'configs' / 'st_gan_3x4x_2f.json').read_text())
    config['name'] = 'st_gan_small'
    (pb / 'configs' / 'st_gan_small.json').write_text(json.dumps(config))
    traffic = json.loads((pb / 'traffic' / 'fwp.node.json').read_text())
    traffic.update(domain=[8, 4, 8], fwp_chunk_shape=[4, 4, 4])
    (pb / 'traffic' / 'fwp.small.json').write_text(json.dumps(traffic))
    (pb / 'metrics' / 'fwp.chunks_per_pass.py').write_text(NEW_METRIC)
    bench = json.loads((root / 'BENCHMARK.json').read_text())
    bench['configs'].append({
        'name': 'st_gan_small', 'source': 'https://example.org/small',
        'file': 'portbench/configs/st_gan_small.json', 'reduced': [],
        'why': 'a second configuration'})
    bench['workloads'].append({
        'name': 'small.fwp', 'config': 'st_gan_small',
        'traffic': 'fwp.small', 'chips': 1, 'why': 'a new cell'})
    bench['per_layer'].append({
        'name': 'fwp.chunks_per_pass', 'unit': 'chunks', 'better': 'higher',
        'source': 'program_counter', 'layer': 'pipeline.forward_pass',
        'moves': 'fwp_hr_voxels_per_s', 'workloads': ['small.fwp']})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    for path, digest in before.items():
        with open(path, 'rb') as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == digest, path
    cell, record = tiny.run_cell(root, 'small.fwp', seconds=0.5)
    assert record['correct'], record['checks']
    got = harness.read_metrics(cell['per_layer'], record, root=pb)
    # 2 x 1 spatial chunks of (4, 4) by 2 time chunks of 4
    assert got['fwp.chunks_per_pass']['value'] == 4


def test_guard_compares_whole_top_level_names():
    modules = {'jax.x': 1, 'sup3r_tpu.y': 1, 'sup3r_tpu_torch.z': 1,
               'jaxtyping': 1, 'flax': 1, 'optax.contrib': 1, 'numpy': 1}
    assert harness.forbidden_modules(modules) == [
        'flax', 'jax.x', 'optax.contrib', 'sup3r_tpu.y']
    assert harness.forbidden_modules({'sup3r_tpu_torch.z': 1}) == []


def test_result_line_has_the_contracts_keys(tmp_path):
    root = tiny.make(tmp_path)
    cell, record = tiny.run_cell(root, 'st3x4x.fwp.node', seconds=0.5)
    record['device_name'] = 'NVIDIA H100 80GB HBM3'
    for trace in (False, True):
        line = finish(cell, record, trace, 1)
        keys = list(line)
        assert keys[:5] == ['correct', 'attempted', 'failed', 'metrics',
                            'device']
        assert keys[-1] == 'checks'
        assert set(keys) <= set(harness.RESULT_KEYS)
        assert set(line['device']) >= {'platform', 'kind', 'count',
                                       'memory_peak_bytes'}
        json.dumps(line)
    names = set(finish(cell, record, False, 1)['metrics'])
    assert names == {'fwp_hr_voxels_per_s', 'fwp_pass_ms_p90', 'setup_s'}
    assert all(set(c) == {'value', 'limit'}
               for c in line['checks'].values())


def test_no_card_fails_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip('a card is present')
    proc = subprocess.run(
        [sys.executable, str(tiny.REPO / 'portbench' / 'run.py'),
         '--workload', 'st3x4x.fwp.node', '--seed', '1', '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, timeout=120,
        cwd=tiny.REPO)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''


def alter_answer(monkeypatch):
    """Each generated chunk altered where it is produced."""
    from sup3r_tpu_torch.models import Sup3rGan

    generate = Sup3rGan.generate

    def altered(self, *args, **kwargs):
        out = generate(self, *args, **kwargs)
        return out + 0.01 * abs(out).max()

    monkeypatch.setattr(Sup3rGan, 'generate', altered)


def half_of_each_dispatch(monkeypatch):
    """A device batch's first half run, its second half left out (the
    first half's outputs in its place)."""
    import torch

    from sup3r_tpu_torch.models import Sup3rGan

    generate = Sup3rGan.generate

    def half(self, low_res, *args, **kwargs):
        n = len(low_res)
        if n < 2:
            return generate(self, low_res, *args, **kwargs)
        out = generate(self, low_res[:n // 2], *args, **kwargs)
        cat = torch.cat if isinstance(out, torch.Tensor) else np.concatenate
        return cat([out, out[:n - n // 2]])

    monkeypatch.setattr(Sup3rGan, 'generate', half)


def state_unchanged(monkeypatch):
    """A step that returns its state unchanged: no update applied."""
    from sup3r_tpu_torch.models.optimizers import Optimizer

    monkeypatch.setattr(Optimizer, 'update', lambda self, *a, **k: None)


def state_unchanged_in_the_window(monkeypatch):
    """Set-up's steps sound, every later step returning its state
    unchanged (a path that changes once the loop runs steady)."""
    from sup3r_tpu_torch.models.optimizers import Optimizer

    update = Optimizer.update
    calls = [0]

    def late(self, *args, **kwargs):
        calls[0] += 1
        # two updates a step (generator, discriminator), 3 set-up steps
        if calls[0] <= 6:
            update(self, *args, **kwargs)

    monkeypatch.setattr(Optimizer, 'update', late)


def half_of_each_batch(monkeypatch):
    """Half of each training batch left out, the mean taken over the
    rest."""
    from sup3r_tpu_torch.models import Sup3rGan

    step = Sup3rGan.run_gradient_descent

    def half(self, low_res, hi_res_true, *args, **kwargs):
        n = len(low_res) // 2
        return step(self, low_res[:n], hi_res_true[:n], *args, **kwargs)

    monkeypatch.setattr(Sup3rGan, 'run_gradient_descent', half)


@pytest.mark.parametrize('cell, fault', [
    ('st3x4x.fwp.node', alter_answer),
    ('st3x4x.fwp.node', half_of_each_dispatch),
    ('ccwind.fwp.stream', alter_answer),
    ('st3x4x.train.b16', state_unchanged),
    ('st3x4x.train.b16', state_unchanged_in_the_window),
    ('st3x4x.train.b16', half_of_each_batch),
], ids=lambda v: getattr(v, '__name__', v))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell,
                                            fault):
    root = tiny.make(tmp_path)
    _, sound = tiny.run_cell(root, cell, seconds=0.3)
    assert sound['correct'], sound['checks']
    fault(monkeypatch)
    _, broken = tiny.run_cell(root, cell, seconds=0.3)
    assert not broken['correct'], broken['checks']


@pytest.mark.parametrize('mode', ['tf32', 'half_batch', 'float64'])
def test_training_controls_run(tmp_path, mode):
    """The training control, the planted fault and the float64 witness
    read every number on a tiny cell (on the CPU TF32 changes nothing,
    so only the half batch has to fail a limit here)."""
    from portbench import control

    root = tiny.make(tmp_path)
    cell = harness.find_cell(harness.load_json(root / 'BENCHMARK.json'),
                             'st3x4x.train.b16', root=root / 'portbench')
    limits = cell['traffic']['limits']
    if mode == 'float64':
        got = control.train_float64(cell, 12345678901, 'cpu')
        for side in ('program', 'reference_fp32', 'program_vs_fp32'):
            assert all(np.isfinite(got[f'{side}.{k}']) for k in limits)
        return
    got = control.train_control(cell, 12345678901, 'cpu', mode)
    for key in limits:
        assert all(np.isfinite(got[k]) for k in
                   (key, f'steps.{key}', f'step.{key}'))
    if mode == 'half_batch':
        assert any(got[f'step.{k}'] > v for k, v in limits.items())
        assert any(got[f'steps.{k}'] > v for k, v in limits.items())


def test_training_numbers_leave_out_what_is_nought_to_rounding():
    """A network whose reference gradient has fallen under a thousandth
    of the first step's median leaf (a saturated discriminator) is left
    out of the gradient's numbers; a reading that is not a number counts
    as infinite."""
    import torch

    from portbench.drivers import train

    g = [torch.ones(3) * 2.0, torch.ones(4)]
    d = [torch.ones(2), torch.ones(5) * 3.0]
    ref = ([(1.0, 0.5)], (g, d), [t * 0.1 for t in g + d])
    scale = train.scales(ref, 2)
    prog = {'losses': [(1.0, 0.5)], 'first': (g, d),
            'change': [t * 0.1 for t in g + d]}
    assert train.compare(prog, ref, 2, scale) == dict.fromkeys(
        train.READINGS, 0.0)
    # the discriminator's reference gradient all but zero, the program's
    # exactly zero: not compared, while a gap in the generator's shows
    tiny = [t * 1e-30 for t in d]
    ref_k = ([(1.0, 1e-9)], (g, tiny), [t * 0.1 for t in g + d])
    prog_k = {'losses': [(1.0, 1e-9)], 'first': (
        [g[0], g[1] * 1.5], [torch.zeros_like(t) for t in d]),
        'change': [t * 0.1 for t in g + d]}
    got = train.compare(prog_k, ref_k, 2, scale)
    # leaf norms 2 sqrt(3) and 2 (the median 1 + sqrt(3)); the program's
    # second reads 3
    assert got['grad_worst_leaf_gap'] == pytest.approx(1 / (1 + 3 ** 0.5))
    assert got['change_norm_gap'] == 0.0
    nan = {**prog, 'change': [t * float('nan') for t in g + d]}
    assert train.compare(nan, ref, 2, scale)['change_norm_gap'] == float(
        'inf')
