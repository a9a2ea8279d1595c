"""The readers of the program's own spans and counters
(``metrics/_program_trace.py`` and the metrics that use it): each from a
planted snapshot, none where the run's process has no trace module (a
program without it) or the record is another kind's, and a tiny traced
run on the CPU reporting them through the result line."""

import json
import sys
import types

import pytest

from portbench import harness
from portbench.metrics import _program_trace
from portbench.run import finish
from portbench.tests import tiny


def span(count, total_s):
    return {'count': count, 'total_s': total_s, 'self_s': total_s / 2}


#: two passes and four steps, each reading's total known
PLANTED = {
    'spans': {'fwp.run': span(2, 0.8), 'strategy.init': span(2, 0.024),
              'fwp.prep_wait': span(16, 0.05), 'fwp.dispatch': span(4, 0.4),
              'fwp.drain': span(4, 0.7), 'fwp.drain_wait': span(2, 0.34),
              'train.step': span(4, 4.4), 'batches.wait': span(4, 0.002),
              'batches.stage': span(4, 0.092)},
    'device': {'model.generate': {'count': 4, 'total_s': 0.66},
               'train.forward': {'count': 4, 'total_s': 0.68},
               'train.gen_grad': {'count': 4, 'total_s': 2.8},
               'train.disc_grad': {'count': 4, 'total_s': 0.944},
               'train.update': {'count': 4, 'total_s': 0.0032}},
    'counts': {'fwp.d2h_bytes': 2 * 31850496, 'fwp.chunks': 32}}
#: metric, the kind it reads, its reading of ``PLANTED``
READINGS = [
    ('fwp.strategy_init_ms', 'fwp', 12.0),
    ('fwp.prep_wait_ms', 'fwp', 25.0),
    ('fwp.dispatch_ms', 'fwp', 200.0),
    ('fwp.drain_ms', 'fwp', 350.0),
    ('fwp.drain_wait_ms', 'fwp', 170.0),
    ('fwp.d2h_mb', 'fwp', 30.375),
    ('fwp.generate_device_ms', 'fwp', 330.0),
    ('train.feed_wait_ms', 'train', 0.5),
    ('train.stage_ms', 'train', 23.0),
    ('train.forward_ms', 'train', 170.0),
    ('train.gen_grad_ms', 'train', 700.0),
    ('train.disc_grad_ms', 'train', 236.0),
    ('train.update_ms', 'train', 0.8),
]
NAMES = [name for name, _, _ in READINGS]


def reader(name):
    return harness.load_module(harness.HERE / 'metrics' / f'{name}.py')


def plant(monkeypatch, snap):
    monkeypatch.setitem(sys.modules, _program_trace.MODULE,
                        types.SimpleNamespace(snapshot=lambda: snap))


@pytest.mark.parametrize('name, kind, want', READINGS)
def test_reads_a_planted_snapshot(monkeypatch, name, kind, want):
    plant(monkeypatch, PLANTED)
    assert reader(name).read({'kind': kind}) == pytest.approx(want)
    other = 'train' if kind == 'fwp' else 'fwp'
    assert reader(name).read({'kind': other}) is None


@pytest.mark.parametrize('name', NAMES)
def test_nothing_to_read_gives_none(monkeypatch, name):
    kind = 'fwp' if name.startswith('fwp.') else 'train'
    monkeypatch.delitem(sys.modules, _program_trace.MODULE, raising=False)
    assert reader(name).read({'kind': kind}) is None
    empty = {'spans': {}, 'device': {}, 'counts': {}}
    plant(monkeypatch, empty)
    assert reader(name).read({'kind': kind}) is None
    # the spans without the unit that counts passes or steps
    plant(monkeypatch, {**PLANTED, 'spans': {
        k: v for k, v in PLANTED['spans'].items()
        if k not in ('fwp.run', 'train.step')}})
    assert reader(name).read({'kind': kind}) is None


def test_entries_name_their_cells_and_readers():
    bench = harness.load_json(tiny.REPO / 'BENCHMARK.json')
    entries = {m['name']: m for m in bench['per_layer']}
    for name, kind, _ in READINGS:
        entry = entries[name]
        cell = 'st3x4x.fwp.node' if kind == 'fwp' else 'st3x4x.train.b16'
        assert entry['workloads'] == [cell]
        assert entry['source'] == ('program_counter' if name == 'fwp.d2h_mb'
                                   else 'program_span')
        assert (harness.HERE / 'metrics' / f'{name}.py').exists()


@pytest.mark.parametrize('cell', ['st3x4x.fwp.node', 'st3x4x.train.b16'])
def test_a_traced_run_reports_the_programs_metrics(tmp_path, cell):
    """The program's own readings from a traced stretch on the CPU (the
    staging copy runs only on a card: ``train.stage_ms`` waits for one);
    an untraced run's line has none of them."""
    from sup3r_tpu_torch.utilities import trace

    root = tiny.make(tmp_path)
    trace.reset()
    # the stretch opens once the window's first step is done: give it
    # time to open on a loaded machine
    found, record = tiny.run_cell(root, cell, seconds=3.0, trace=True)
    assert record['profile'] is not None
    record['device_name'] = 'cpu'
    line = finish(found, record, True, 1)
    kind = 'fwp' if 'fwp' in cell else 'train'
    want = {name for name, k, _ in READINGS if k == kind} - {
        'train.stage_ms'}
    assert want <= set(line['metrics']), sorted(line['metrics'])
    json.dumps(line)
    assert line['metrics']['train.forward_ms' if kind == 'train'
                           else 'fwp.d2h_mb']['value'] > 0
    trace.reset()
    assert not set(finish(found, record, False, 1)['metrics']) & set(NAMES)
