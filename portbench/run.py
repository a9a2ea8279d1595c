#!/usr/bin/env python3
"""Benchmark of ``sup3r_tpu_torch`` on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json``
names its configuration (``portbench/configs/<config>.json``) and its
traffic (``portbench/traffic/<traffic>.json``, whose ``kind`` picks the
loop in ``portbench/drivers/<kind>.py``); each metric the cell reports
is read by ``portbench/metrics/<metric>.py``. The run makes its inputs
and weights from ``--seed``, warms up (set-up), measures for
``--seconds``, checks the timed path's outputs against the plain
reference in ``portbench/reference/``, and prints one JSON line last on
standard output. With ``--trace 0`` it reports the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a short profiled
stretch of the window.

It exits non-zero without a result when there is no CUDA card (or fewer
than the cell asks for), or when a module of JAX or of the JAX package
(``sup3r_tpu``) is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_env(root=ROOT):
    """Every build and kernel cache inside the checkout, at fixed paths;
    ``transformers`` kept from loading flax."""
    cache = root / 'build' / 'portbench_cache'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['USE_FLAX'] = '0'


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def finish(cell, record, trace, chips):
    """The result line of a run from its driver's record: the cell's
    end-to-end metrics (``trace`` off) or per-layer metrics (on), the
    device, the profiled stretch's breakdown and the checks, last."""
    from portbench.harness import read_metrics, result_line

    metrics = read_metrics(
        cell['per_layer'] if trace else cell['end_to_end'], record)
    device = {'platform': 'gpu', 'kind': record['device_name'],
              'count': chips,
              'memory_peak_bytes': int(record['memory_peak_bytes'])}
    breakdown = None
    prof = record.get('profile')
    if trace and prof:
        device.update(busy_s=prof['busy_s'], window_s=prof['window_s'])
        breakdown = {'device_ops': prof['device_ops'],
                     'idle_gaps': prof['idle_gaps']}
    return result_line(record['correct'], record['attempted'],
                       record['failed'], metrics, device, record['checks'],
                       breakdown)


def main(argv=None):
    args = parse(argv)
    cache_env()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness import (
        HERE,
        find_cell,
        forbidden_modules,
        load_json,
        load_module,
    )

    cell = find_cell(load_json(ROOT / 'BENCHMARK.json'), args.workload)
    chips = int(cell['entry']['chips'])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: {args.workload} needs {chips} CUDA card(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    driver = load_module(HERE / 'drivers' / f'{cell["traffic"]["kind"]}.py')
    record = driver.run(cell, seed=args.seed, seconds=args.seconds,
                        trace=bool(args.trace), t_start=T_START,
                        device='cuda')
    found = forbidden_modules()
    if found:
        print('portbench: modules of JAX or of the JAX package are loaded: '
              + ', '.join(found), file=sys.stderr)
        return 3
    line = finish(cell, record, bool(args.trace), chips)
    for name, check in line['checks'].items():
        print(f'check {name}: {check["value"]!r} (limit {check["limit"]!r})',
              file=sys.stderr)
    import json

    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
