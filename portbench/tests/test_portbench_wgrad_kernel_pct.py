"""The ``train.wgrad_kernel_pct`` reader: the share of a stretch's fused
generator blocks' weight gradients that ran on the hand-written
``reflect_conv_wgrad`` kernel, from a planted snapshot with the program's
route counters; None without them, without the program's trace module or
outside a ``train`` record; and a tiny traced run on the CPU reporting it
through the result line."""

import sys

import pytest

from portbench import harness
from portbench.metrics import _program_trace
from portbench.run import finish
from portbench.tests import tiny
from portbench.tests.test_portbench_program_trace import (PLANTED, plant,
                                                          reader)

NAME = 'train.wgrad_kernel_pct'

#: the weight-gradient route counters of a stretch, and the share they give
WGRAD_COUNTS = [({'conv_ad.wgrad_kernel': 111}, 100.0),
                ({'conv_ad.wgrad_kernel': 108, 'conv_ad.wgrad_cudnn': 3},
                 97.2973),
                ({'conv_ad.wgrad_cudnn': 111}, 0.0)]


@pytest.mark.parametrize('counts, want', WGRAD_COUNTS)
def test_wgrad_kernel_pct_reads_the_route_counters(monkeypatch, counts,
                                                   want):
    plant(monkeypatch, {**PLANTED, 'counts': {**PLANTED['counts'],
                                              **counts}})
    read = reader(NAME).read
    assert read({'kind': 'train'}) == pytest.approx(want, abs=1e-4)
    assert read({'kind': 'fwp'}) is None


def test_wgrad_kernel_pct_without_the_counters_gives_none(monkeypatch):
    read = reader(NAME).read
    monkeypatch.delitem(sys.modules, _program_trace.MODULE, raising=False)
    assert read({'kind': 'train'}) is None
    # a program whose trace module has no route counters
    plant(monkeypatch, PLANTED)
    assert read({'kind': 'train'}) is None


def test_wgrad_kernel_pct_entry_names_its_cell():
    bench = harness.load_json(tiny.REPO / 'BENCHMARK.json')
    entry = next(m for m in bench['per_layer'] if m['name'] == NAME)
    assert entry['workloads'] == ['st3x4x.train.b16']
    assert (entry['source'], entry['layer'], entry['moves']) == (
        'program_counter', 'ops.kernels', 'train_step_ms')
    assert (harness.HERE / 'metrics' / f'{NAME}.py').exists()


def test_a_traced_train_run_reports_the_share(tmp_path):
    """On the CPU every weight gradient takes the library route, so a
    traced stretch reads 0; an untraced run's line leaves the metric
    out."""
    from sup3r_tpu_torch.utilities import trace

    root = tiny.make(tmp_path)
    trace.reset()
    found, record = tiny.run_cell(root, 'st3x4x.train.b16', seconds=6.0,
                                  trace=True)
    assert record['profile'] is not None
    record['device_name'] = 'cpu'
    line = finish(found, record, True, 1)
    assert line['metrics'][NAME]['value'] == 0.0
    trace.reset()
    assert NAME not in finish(found, record, False, 1)['metrics']
