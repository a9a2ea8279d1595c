"""What every cell of the benchmark shares: finding a cell's files by
name, the guard against JAX, the seeded weights, NetCDF3 inputs, the
profiled stretch and the result line.

Nothing here imports the program; the drivers do.
"""

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run's process:
#: the JAX package the program was ported from and its runtime
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'sup3r_tpu')
#: the keys of the result line, in order (``breakdown`` with --trace 1)
RESULT_KEYS = ('correct', 'attempted', 'failed', 'metrics', 'device',
               'breakdown', 'checks')


def forbidden_modules(modules=None):
    """Names in ``modules`` (``sys.modules`` by default) whose top-level
    name, the part before the first dot, is one of ``FORBIDDEN``."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split('.')[0] in FORBIDDEN)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """Import a Python file of the benchmark by its path (metric and
    driver files are named by the metrics and kinds they serve, which
    may hold dots)."""
    path = Path(path)
    name = f'portbench_{path.parent.name}_{path.stem}'.replace(
        '.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(benchmark, cell, root=HERE):
    """Everything a run of ``cell`` needs, found by name: its entry in
    ``BENCHMARK.json``, its configuration and traffic files, and the
    metrics it reports with --trace 0 and --trace 1."""
    entries = {w['name']: w for w in benchmark['workloads']}
    if cell not in entries:
        raise KeyError(f'no cell {cell!r}; cells: {sorted(entries)}')
    entry = entries[cell]
    configs = {c['name']: c for c in benchmark['configs']}
    config_file = root.parent / configs[entry['config']]['file']
    traffic = load_json(root / 'traffic' / f'{entry["traffic"]}.json')

    def applies(metric):
        return cell in metric.get('workloads', [cell])

    e2e = [m for m in benchmark['end_to_end'] if applies(m)]
    e2e_names = {m['name'] for m in e2e}
    per_layer = [m for m in benchmark['per_layer'] if applies(m)
                 and ('workloads' in m or m['moves'] in e2e_names)]
    return {'name': cell, 'entry': entry, 'config': load_json(config_file),
            'traffic': traffic, 'end_to_end': e2e, 'per_layer': per_layer}


def read_metrics(metrics, record, root=HERE):
    """{name: {'value', 'unit'}} of each metric whose reader
    (``metrics/<name>.py``, ``read(record)``) finds something to read."""
    out = {}
    for metric in metrics:
        reader = load_module(root / 'metrics' / f'{metric["name"]}.py')
        value = reader.read(record)
        if value is not None:
            out[metric['name']] = {'value': float(value),
                                   'unit': metric['unit']}
    return out


def small_kernel_launch(layers, in_shape):
    """(x shape channels-first, co, n weights) of the first reflect conv
    of a layer list that the program gives its small-channel kernel (3D,
    ci * co <= 32), for a channels-last input shape; None if there is
    none."""
    from portbench.reference.network import walk_shapes

    prev = None
    for layer, s_in, s_out in walk_shapes(layers, in_shape):
        if layer['class'] == 'Conv3D' and prev is not None:
            ci, co = s_in[-1], s_out[-1]
            if ci * co <= 32:
                return (prev[0], prev[-1], *prev[1:-1]), co, co * ci * 27
        prev = s_in if layer['class'] == 'FlexiblePadding' else None
    return None


def seed_rng(seed, *stream):
    """A numpy generator for one named stream of ``seed`` (any whole
    number, of any size)."""
    return np.random.default_rng([int(seed) % 2 ** 63, *stream])


def torch_seed(seed, stream):
    """A 63-bit seed for a ``torch.Generator``, from ``seed`` and a
    stream number."""
    return int(seed_rng(seed, stream).integers(0, 2 ** 63 - 1))


def make_weights(shapes, seed, stream, device, bias_scale=0.05):
    """Weights of one network from ``seed``, in a few large calls of a
    ``torch.Generator`` on ``device``: each weight U(-l, l) with the
    Glorot limit l = sqrt(6 / (fan_in + fan_out)), each bias U(-b, b).
    ``shapes`` is [(weight shape, bias shape)]; returns the flat
    [w0, b0, w1, b1, ...] float32 list."""
    import torch

    sizes = [math.prod(s) for pair in shapes for s in pair]
    gen = torch.Generator(device=device).manual_seed(
        torch_seed(seed, stream))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    out, start = [], 0
    for w_shape, b_shape in shapes:
        receptive = math.prod(w_shape[2:])
        fan_in, fan_out = w_shape[1] * receptive, w_shape[0] * receptive
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        for shape, scale in ((w_shape, limit), (b_shape, bias_scale)):
            n = math.prod(shape)
            out.append((flat[start:start + n] * scale).reshape(shape))
            start += n
    return out


def write_nc(path, data, lat, lon, hours, start_hours=0.0):
    """A NetCDF3 file of (time, lat, lon) float32 variables, ``data``
    mapping a name to its (s1, s2, t) array; time in hours since
    1900-01-01 at ``hours`` apart."""
    from scipy.io import netcdf_file

    s1, s2, t = next(iter(data.values())).shape
    with netcdf_file(path, 'w') as f:
        f.createDimension('time', t)
        f.createDimension('lat', s1)
        f.createDimension('lon', s2)
        v = f.createVariable('time', 'f8', ('time',))
        v[:] = start_hours + hours * np.arange(t)
        v.units = b'hours since 1900-01-01'
        v.calendar = b'standard'
        f.createVariable('lat', 'f4', ('lat',))[:] = lat
        f.createVariable('lon', 'f4', ('lon',))[:] = lon
        for name, arr in data.items():
            var = f.createVariable(name, 'f4', ('time', 'lat', 'lon'))
            var[:] = np.ascontiguousarray(
                np.moveaxis(arr, 2, 0), dtype=np.float32)
    return path


def write_static_nc(path, name, values, lat, lon):
    """A NetCDF3 file of one static (lat, lon) variable on 1D axes."""
    from scipy.io import netcdf_file

    with netcdf_file(path, 'w') as f:
        f.createDimension('lat', len(lat))
        f.createDimension('lon', len(lon))
        f.createVariable('lat', 'f4', ('lat',))[:] = lat
        f.createVariable('lon', 'f4', ('lon',))[:] = lon
        f.createVariable(name, 'f4', ('lat', 'lon'))[:] = np.asarray(
            values, dtype=np.float32)
    return path


def work_dir(cell, seed):
    """A run's own directory for its inputs and saved models, under
    ``TMPDIR``."""
    base = os.environ.get('TMPDIR') or '/tmp'
    path = Path(base) / 'portbench' / f'{cell}-{seed}-{os.getpid()}'
    path.mkdir(parents=True, exist_ok=True)
    return path


class Window:
    """The measured window: runs ``step()`` until ``seconds`` have
    passed since it opened (the step running then finishes inside the
    window). With ``profile`` the steps numbered ``profile`` (a range)
    run under ``torch.profiler``; ``spans`` names the host's work."""

    def __init__(self, seconds, device, profile=None):
        self.seconds = seconds
        self.device = device
        self.profile_steps = profile
        self.prof = None
        #: whether the step running now is in the profiled stretch, and
        #: the stretch's wall seconds, the profiler's start and stop
        #: included (rates read with --trace 1 leave both out)
        self.in_stretch = False
        self.stretch_s = 0.0

    def run(self, step):
        results = []
        sync(self.device)
        t0 = self.t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < self.seconds:
            if self.profile_steps is not None and i == self.profile_steps[0]:
                results.append(self._profiled(step, len(self.profile_steps)))
                i += len(self.profile_steps)
                continue
            results.append(step())
            i += 1
        sync(self.device)
        self.elapsed = time.perf_counter() - t0
        return results

    def since_open(self):
        """Seconds since the window opened."""
        return time.perf_counter() - self.t0

    def _profiled(self, step, n):
        from torch.profiler import ProfilerActivity, profile, record_function

        sync(self.device)
        activities = [ProfilerActivity.CPU]
        if self.device != 'cpu':
            activities.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        self.in_stretch = True
        with profile(activities=activities) as prof:
            with record_function('portbench.stretch'):
                out = [step() for _ in range(n)]
                sync(self.device)
        self.in_stretch = False
        self.stretch_s = time.perf_counter() - t0
        self.prof = prof
        return out


class Phases:
    """Seconds since the process started at named points of a run's
    set-up, printed on standard error."""

    def __init__(self, t_start):
        self.t_start = t_start
        self.marks = []

    def __call__(self, name):
        self.marks.append((name, time.perf_counter() - self.t_start))

    def print(self):
        print('portbench: set-up reached ' + ', '.join(
            f'{name} at {t:.3f} s' for name, t in self.marks),
            file=sys.stderr)


def sync(device):
    """Wait for the card (nothing to wait for on the CPU)."""
    if device != 'cpu':
        import torch

        torch.cuda.synchronize()


def profile_summary(prof, kernels=()):
    """What the benchmark reads from a profiled stretch: its length and
    the union of the device's busy intervals inside it (s), each
    kernel's launches and device s (for the names in ``kernels``), the
    device operations that took most time, and the longest idle gaps
    named by the benchmark's innermost host span around them."""
    from torch.autograd import DeviceType

    events = prof.events()
    stretch = [e for e in events if e.name == 'portbench.stretch'
               and e.device_type == DeviceType.CPU]
    if not stretch:
        return None
    w0, w1 = stretch[0].time_range.start, stretch[0].time_range.end
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == DeviceType.CUDA
                 and not getattr(e, 'is_user_annotation', False)
                 and not e.name.startswith('portbench.')
                 and e.time_range.end > w0 and e.time_range.start < w1)
    busy, gaps, cursor = 0.0, [], w0
    for start, end, _ in dev:
        start, end = max(start, w0), min(end, w1)
        if start > cursor:
            gaps.append((cursor, start))
        if end > cursor:
            busy += end - max(start, cursor)
            cursor = end
    if w1 > cursor:
        gaps.append((cursor, w1))
    spans = [e for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith('portbench.')
             and e.name != 'portbench.stretch']

    def host_at(t):
        inner = [s for s in spans
                 if s.time_range.start <= t <= s.time_range.end]
        if not inner:
            return 'host'
        return min(inner, key=lambda s: s.time_range.end
                   - s.time_range.start).name[len('portbench.'):]

    totals = {}
    for start, end, name in dev:
        totals[name] = totals.get(name, 0.0) + (end - start)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    gap_names = {}
    for a, b in gaps:
        key = host_at((a + b) / 2)
        gap_names[key] = gap_names.get(key, 0.0) + (b - a)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    kernel_stats = {}
    for k in kernels:
        hits = [end - start for start, end, name in dev if k in name]
        kernel_stats[k] = (len(hits), sum(hits) / 1e6)
    return {
        'window_s': (w1 - w0) / 1e6, 'busy_s': busy / 1e6,
        'kernels': kernel_stats,
        'device_ops': [[n[:120], t / 1e6] for n, t in top],
        'idle_gaps': [[host_at((a + b) / 2), (b - a) / 1e6]
                      for a, b in longest],
        'idle_by_host': {k: v / 1e6 for k, v in gap_names.items()},
    }


def span(name):
    """A host span of the benchmark's, seen by the profiler."""
    from torch.profiler import record_function

    return record_function(f'portbench.{name}')


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None):
    """The result's JSON object with the keys in their order; the checks
    come last."""
    out = {'correct': bool(correct), 'attempted': int(attempted),
           'failed': int(failed), 'metrics': metrics, 'device': device}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['checks'] = checks
    return out


def judge(readings, limits):
    """{name: {'value', 'limit'}} of each number compared, and whether
    every one is within its limit (a missing or non-finite reading
    fails)."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {'value': value, 'limit': limit}
    return checks, ok
