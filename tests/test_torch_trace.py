"""The program's spans and counters (``sup3r_tpu_torch/utilities/trace.py``)
on the CPU: with no profiler running nothing is entered or recorded;
under ``torch.profiler.profile`` the registry holds the forward pass's,
the feed's and the train step's spans with the counts of passes,
dispatches, chunks and steps, the main thread's spans reach the
profiler's events with their ids, a span's self time is its total less
its children's, spans of worker threads reach the registry, and
``profile_to_dir`` logs the table."""

import inspect
import logging
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sup3r_tpu_torch.configs import generator_st
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.abstract import supports_fetch
from sup3r_tpu_torch.models.utilities import profile_to_dir
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.preprocessing import BatchHandler
from sup3r_tpu_torch.utilities import Timer, trace
from sup3r_tpu_torch.utilities.test_helpers import (
    make_fake_dset,
    make_fake_nc_file,
)

torch.set_num_threads(1)

FEATURES = ['u_100m', 'v_100m']
CPU = [ProfilerActivity.CPU]
#: the tiny node: a (8, 8, 8) domain in (4, 4, 4) chunks, 2 a dispatch
DOMAIN, CHUNK, PAD, BATCH = (8, 8, 8), (4, 4, 4), 1, 2
N_CHUNKS, N_DISPATCHES = 8, 4
#: the host spans of one pass, each with its count
PASS_SPANS = {'fwp.run': 1, 'fwp.init': 1, 'strategy.init': 1,
              'strategy.model': 1, 'strategy.read': 1, 'strategy.plan': 1,
              'strategy.exo': 1, 'fwp.prep': N_CHUNKS,
              'strategy.prep_chunk_data': N_CHUNKS,
              'fwp.prep_wait': N_CHUNKS, 'fwp.dispatch': N_DISPATCHES,
              'fwp.stack': N_DISPATCHES, 'fwp.h2d': N_DISPATCHES,
              'model.generate': N_DISPATCHES, 'fwp.drain': N_DISPATCHES,
              'fwp.d2h': N_DISPATCHES, 'fwp.check': N_CHUNKS,
              'fwp.drain_wait': 1}
#: the train step's device spans, which tile ``_train_step``
PHASES = ('train.forward', 'train.gen_grad', 'train.disc_grad',
          'train.update')


def _disc():
    return {'hidden_layers': [
        {'class': 'Conv3D', 'filters': 4, 'kernel_size': 3, 'strides': 2,
         'padding': 'same'},
        {'class': 'LeakyReLU', 'alpha': 0.2},
        {'class': 'Flatten'},
        {'class': 'Dense', 'units': 1}]}


def _model():
    model = Sup3rGan(
        generator_st(2, (2,), (2,), filters=8, n_resblocks=1), _disc(),
        meta={'lr_features': FEATURES, 'hr_out_features': FEATURES,
              's_enhance': 2, 't_enhance': 2,
              'input_resolution': {'spatial': '30km', 'temporal': '60min'}},
        means={f: 0.5 for f in FEATURES}, stdevs={f: 0.3 for f in FEATURES},
        learning_rate=1e-4, device='cpu')
    model.init_weights((1, 4, 4, 4, 2), (1, 8, 8, 8, 2), seed=0)
    return model


@pytest.fixture(scope='module')
def node(tmp_path_factory):
    """A saved tiny model and one NetCDF input: the strategy's
    arguments."""
    root = tmp_path_factory.mktemp('trace')
    _model().save(str(root / 'model'))
    path = make_fake_nc_file(str(root / 'input.nc'), DOMAIN, FEATURES)
    return {'file_paths': path,
            'model_kwargs': {'model_dir': str(root / 'model'),
                             'device': 'cpu'},
            'fwp_chunk_shape': CHUNK, 'spatial_pad': PAD,
            'temporal_pad': PAD, 'device_batch_size': BATCH,
            'out_pattern': None}


def _pass(node):
    return ForwardPass.run(ForwardPassStrategy(**node), 0)


def _step(model, seed=0):
    rng = np.random.default_rng(seed)
    lr = rng.random((2, 4, 4, 4, 2), dtype=np.float32)
    hr = rng.random((2, 8, 8, 8, 2), dtype=np.float32)
    return model.run_gradient_descent(lr, hr, train_gen=True,
                                      train_disc=True)


@pytest.fixture(autouse=True)
def empty_registry():
    trace.reset()
    yield
    trace.reset()


def test_off_enters_no_record_function_and_records_nothing(node,
                                                          monkeypatch):
    """No profiler: a pass and a step enter no ``record_function``, make
    no CUDA event and leave the registry as it was."""
    entered = []
    real = torch.profiler.record_function

    def counting(*args, **kwargs):
        entered.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, 'record_function', counting)
    monkeypatch.setattr(torch.cuda, 'Event',
                        lambda *a, **k: entered.append('event'))
    model = _model()
    before = trace.snapshot()
    _pass(node)
    _step(model)
    with profile_to_dir(None, enabled=False):
        _step(model)
    assert entered == []
    assert trace.snapshot() == before


def test_forward_pass_spans_count_passes_dispatches_and_chunks(node):
    with profile(activities=CPU):
        outs = [_pass(node) for _ in range(2)]
    snap = trace.snapshot()
    assert {k: v['count'] for k, v in snap['spans'].items()} == {
        k: 2 * n for k, n in PASS_SPANS.items()}
    assert snap['device'] == {'model.generate': {
        'count': 2 * N_DISPATCHES,
        'total_s': snap['device']['model.generate']['total_s']}}
    counts = snap['counts']
    assert counts['fwp.chunks'] == 2 * N_CHUNKS
    assert counts['fwp.dispatches'] == 2 * N_DISPATCHES
    # the cropped outputs, each chunk once
    assert counts['fwp.d2h_bytes'] == sum(
        o.nbytes for out in outs for o in out.values())
    padded = [c + 2 * PAD for c in CHUNK]
    assert counts['fwp.h2d_bytes'] == 2 * N_DISPATCHES * BATCH * 4 * (
        np.prod(padded) * len(FEATURES))
    for name, row in snap['spans'].items():
        assert 0 <= row['self_s'] <= row['total_s'], name
    spans = snap['spans']
    assert spans['fwp.run']['total_s'] >= (
        spans['fwp.init']['total_s'] + spans['fwp.prep_wait']['total_s']
        + spans['fwp.dispatch']['total_s']
        + spans['fwp.drain_wait']['total_s'])


def test_profiler_events_hold_the_main_threads_spans_with_ids(node):
    """The main thread's spans are profiler events named ``sup3r.<name>``
    (with ``[ids]``); the prep threads' spans reach the registry only."""
    model = _model()
    with profile(activities=CPU) as prof:
        _pass(node)
        _step(model)
    names = {e.name for e in prof.events()}
    runs = [n for n in names if n.startswith('sup3r.fwp.run[')]
    assert len(runs) == 1
    assert runs[0].startswith('sup3r.fwp.run[node=0,pass_index=')
    assert 'sup3r.train.step[step=1]' in names
    for name in ('strategy.init', 'fwp.init', 'fwp.prep_wait',
                 'fwp.dispatch', 'fwp.stack', 'fwp.h2d', 'model.generate',
                 'fwp.drain_wait', 'train.fetch'):
        assert f'sup3r.{name}' in names, name
    assert 'sup3r.fwp.prep' not in names
    assert trace.snapshot()['spans']['fwp.prep']['count'] == N_CHUNKS


def test_self_time_is_total_less_children():
    def nap():
        time.sleep(0.002)

    with profile(activities=CPU):
        with trace.span('outer'):
            nap()
            with trace.span('inner'):
                nap()
                with trace.span('leaf'):
                    nap()
            with trace.span('inner'):
                nap()
    spans = trace.snapshot()['spans']
    outer, inner, leaf = (spans[k] for k in ('outer', 'inner', 'leaf'))
    assert (outer['count'], inner['count'], leaf['count']) == (1, 2, 1)
    assert outer['self_s'] == pytest.approx(
        outer['total_s'] - inner['total_s'], abs=1e-9)
    assert inner['self_s'] == pytest.approx(
        inner['total_s'] - leaf['total_s'], abs=1e-9)
    assert leaf['self_s'] == leaf['total_s'] >= 0.002
    assert outer['self_s'] >= 0.002


def test_worker_threads_reach_the_registry_without_losing_updates():
    """Spans and counters from more threads than cores, switching often,
    all arrive; each thread's self time holds only its own spans."""
    n_threads, n_each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_each):
                with trace.span('worker.outer'):
                    with trace.span('worker.inner'):
                        trace.count('worker.items', 2)

        with profile(activities=CPU) as prof:
            with trace.span('main'):
                with ThreadPoolExecutor(n_threads) as pool:
                    for fut in [pool.submit(work)
                                for _ in range(n_threads)]:
                        fut.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    snap = trace.snapshot()
    assert snap['spans']['worker.outer']['count'] == n_threads * n_each
    assert snap['spans']['worker.inner']['count'] == n_threads * n_each
    assert snap['counts']['worker.items'] == 2 * n_threads * n_each
    main = snap['spans']['main']
    assert main['self_s'] == main['total_s']
    assert 'sup3r.main' in {e.name for e in prof.events()}


def test_train_step_device_spans_once_a_step():
    model = _model()
    _step(model)
    with profile(activities=CPU):
        for seed in range(3):
            _step(model, seed)
    snap = trace.snapshot()
    assert {k: v['count'] for k, v in snap['device'].items()} == dict.fromkeys(
        PHASES, 3)
    assert snap['spans']['train.step']['count'] == 3
    assert snap['spans']['train.fetch']['count'] == 3
    step = snap['spans']['train.step']['total_s']
    phases = sum(snap['device'][k]['total_s'] for k in PHASES)
    assert 0 < phases <= step


def test_feed_spans_and_counters():
    """Each batch is one resumption, one wait and one get (and one more
    resumption finds the end); the first get finds the queue empty
    (counted in ``batches.waited``) without a whole 1 s timeout
    (``starvation_rate`` stays 0)."""
    handler = BatchHandler(
        [make_fake_dset((12, 12, 16), FEATURES)], batch_size=2,
        n_batches=4, s_enhance=2, t_enhance=2, sample_shape=(8, 8, 4),
        queue_cap=2, device='cpu')
    post_proc = handler._queue.post_proc

    def slow(samples):  # each batch takes 20 ms: the first get waits
        time.sleep(0.02)
        return post_proc(samples)

    handler._queue.post_proc = slow
    try:
        with profile(activities=CPU):
            batches = list(handler)
    finally:
        handler.stop()
    snap = trace.snapshot()
    assert len(batches) == 4
    assert snap['spans']['batches.next']['count'] == 5
    assert snap['spans']['batches.wait']['count'] == 4
    assert snap['spans']['batches.produce']['count'] >= 4
    assert snap['counts']['batches.gets'] == 4
    assert 1 <= snap['counts']['batches.waited'] <= 4
    assert handler._queue._gets == 4
    assert handler._queue.starvation_rate == 0.0


def test_timer_routes_through_spans_only_with_a_scope():
    def work():
        return 3

    plain, scoped = Timer(), Timer('unit')
    with profile(activities=CPU):
        assert plain(work)() == 3
        assert scoped(work)() == 3
        assert scoped(work, span='named')() == 3
    assert set(trace.snapshot()['spans']) == {'unit.work', 'unit.named'}
    assert set(plain.log) == set(scoped.log) == {'work'}
    plain(work)()
    assert set(trace.snapshot()['spans']) == {'unit.work', 'unit.named'}


def test_profile_to_dir_logs_the_span_table(tmp_path, caplog):
    model = _model()
    with caplog.at_level(logging.INFO,
                         logger='sup3r_tpu_torch.models.utilities'):
        with profile_to_dir(str(tmp_path)):
            _step(model)
    assert list(tmp_path.glob('*.pt.trace.json'))
    text = caplog.text
    assert 'Program spans of the trace' in text
    for name in ('train.step', 'train.fetch') + PHASES:
        assert name in text, name


def test_decorated_entry_points_keep_their_signatures():
    assert supports_fetch(Sup3rGan)
    assert 'fetch' in inspect.signature(Sup3rGan.generate).parameters
    assert Sup3rGan.generate.__name__ == 'generate'
    assert ForwardPassStrategy.__post_init__.__name__ == '__post_init__'


def test_a_span_opened_before_the_profiler_records_nothing():
    """A span records only when it was entered under a profiler; one
    entered under it records when it closes, even after the profiler
    stopped."""
    with trace.span('before'):
        with profile(activities=CPU):
            pass
    prof = profile(activities=CPU)
    prof.start()
    held = trace.span('across')
    held.__enter__()
    prof.stop()
    held.__exit__(None, None, None)
    assert set(trace.snapshot()['spans']) == {'across'}
    assert threading.current_thread() is threading.main_thread()
