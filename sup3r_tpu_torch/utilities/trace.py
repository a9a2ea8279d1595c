"""Spans and counters inside the program, on only while ``torch.profiler``
records.

``span(name, **ids)`` times a host interval (a context manager, or a
decorator with ``@span(name)``); ``device_span(name, device)`` times the
device work enqueued inside it on the current stream; ``count(name, n)``
adds to a counter. They act only while a profiler session records in the
process: the process-wide flag ``torch.autograd.profiler.
_is_profiler_enabled``, which worker threads see too (torch's own
``_profiler_enabled()`` is per thread and reads False there). Off, a call
reads that flag and returns an empty context: no clock, no lock, no
``record_function``, no CUDA event. Nothing else turns them on: the
benchmark's ``--trace 1`` stretch, ``train(tensorboard_profile=True)``
or any profiler an operator runs around the program does.

On, a span opens ``record_function('sup3r.<name>')``, named
``'sup3r.<name>[k=v,...]'`` with ids (the profiler keeps no other
argument of a user annotation), so the profiler shows it on the device
trace's clock. The default profiler records annotations only from the
thread that started it. Every span, from any thread, also adds its count,
total seconds and self seconds (its own minus those of the spans it
holds on its thread) to a registry under its plain name.

A device span records a start and an end CUDA event (the host clock on
the CPU); ``snapshot()`` resolves the pairs, so nothing waits for the card
on the way. ``snapshot()`` returns ``{'spans': {name: {'count', 'total_s',
'self_s'}}, 'device': {name: {'count', 'total_s'}}, 'counts': {name: n}}``
and ``reset()`` empties the registry.
"""

import functools
import threading
import time

import torch
import torch.autograd.profiler as _profiler

#: the prefix of every span's name in a profiler trace
PREFIX = 'sup3r.'


class _Registry:
    """What the spans and counters added since the last ``reset``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.reset()

    def reset(self):
        with self.lock:
            self.spans = {}
            self.device = {}
            self.counts = {}
            self.pending = []

    def stack(self):
        """The open spans of the calling thread, innermost last."""
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def add_span(self, name, total, own):
        with self.lock:
            n, t, s = self.spans.get(name, (0, 0.0, 0.0))
            self.spans[name] = (n + 1, t + total, s + own)

    def add_device(self, name, seconds):
        with self.lock:
            n, t = self.device.get(name, (0, 0.0))
            self.device[name] = (n + 1, t + seconds)

    def add_count(self, name, n):
        with self.lock:
            self.counts[name] = self.counts.get(name, 0) + n


_REGISTRY = _Registry()


class _Off:
    """What ``span`` and ``device_span`` return while no profiler
    records."""

    __slots__ = ('name',)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, func):
        return _decorate(self.name, func)


class _Span:
    __slots__ = ('name', 'label', 'record', 'start', 'inner')

    def __init__(self, name, ids):
        self.name = name
        self.label = PREFIX + name + (
            '[' + ','.join(f'{k}={v}' for k, v in ids.items()) + ']'
            if ids else '')

    def __enter__(self):
        self.record = torch.profiler.record_function(self.label)
        self.record.__enter__()
        _REGISTRY.stack().append(self)
        self.inner = 0.0
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.start
        stack = _REGISTRY.stack()
        stack.pop()
        if stack:
            stack[-1].inner += seconds
        _REGISTRY.add_span(self.name, seconds, seconds - self.inner)
        self.record.__exit__(*exc)
        return False

    def __call__(self, func):
        return _decorate(self.name, func)


def _decorate(name, func):
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with span(name):
            return func(*args, **kwargs)

    return wrapper


def span(name, **ids):
    """A host span named ``name`` (``ids`` go into its trace name only)."""
    if not _profiler._is_profiler_enabled:
        return _Off(name)
    return _Span(name, ids)


class _DeviceSpan:
    __slots__ = ('name', 'stream', 'start')

    def __init__(self, name, device):
        self.name = name
        device = torch.device(device)
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == 'cuda' else None)

    def __enter__(self):
        if self.stream is None:
            self.start = time.perf_counter()
        else:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.stream is None:
            _REGISTRY.add_device(self.name, time.perf_counter() - self.start)
            return False
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        with _REGISTRY.lock:
            _REGISTRY.pending.append((self.name, self.start, end))
        return False


def device_span(name, device):
    """The device time of the work enqueued inside it on ``device``'s
    current stream (the host clock for a CPU ``device``)."""
    if not _profiler._is_profiler_enabled:
        return _Off(name)
    return _DeviceSpan(name, device)


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    if _profiler._is_profiler_enabled:
        _REGISTRY.add_count(name, n)


def snapshot():
    """The registry's spans, device spans and counters, the device
    spans' events waited for and resolved."""
    with _REGISTRY.lock:
        pending, _REGISTRY.pending = _REGISTRY.pending, []
    for name, start, end in pending:
        end.synchronize()
        _REGISTRY.add_device(name, start.elapsed_time(end) / 1e3)
    with _REGISTRY.lock:
        return {
            'spans': {k: {'count': n, 'total_s': t, 'self_s': s}
                      for k, (n, t, s) in _REGISTRY.spans.items()},
            'device': {k: {'count': n, 'total_s': t}
                       for k, (n, t) in _REGISTRY.device.items()},
            'counts': dict(_REGISTRY.counts)}


def reset():
    """Empty the registry (spans open now still add when they close)."""
    _REGISTRY.reset()


def table(snap, since=None):
    """Lines of a log table of ``snap`` (less ``since``, an earlier
    snapshot): each span's count, total and self ms, each device span's
    count and ms, each counter."""
    since = since or {'spans': {}, 'device': {}, 'counts': {}}
    lines = [f'{"span":<28}{"count":>8}{"total ms":>12}{"self ms":>12}']
    for kind in ('spans', 'device'):
        for name, row in sorted(snap[kind].items()):
            old = since[kind].get(name, {})
            n = row['count'] - old.get('count', 0)
            if not n:
                continue
            total = 1e3 * (row['total_s'] - old.get('total_s', 0.0))
            own = (f'{1e3 * (row["self_s"] - old.get("self_s", 0.0)):12.3f}'
                   if kind == 'spans' else f'{"(device)":>12}')
            lines.append(f'{name:<28}{n:8d}{total:12.3f}{own}')
    for name, n in sorted(snap['counts'].items()):
        n -= since['counts'].get(name, 0)
        if n:
            lines.append(f'{name:<28}{n:8d}')
    return lines
