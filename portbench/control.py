#!/usr/bin/env python3
"""The controls and planted faults that the correctness limits are set
against, run at a cell's own size:

    python3 portbench/control.py --workload <cell> --mode <mode> \
        --seeds <n> [<n> ...]

Modes: ``tf32`` puts the plain reference in the program's place and
computes it with TF32 on (the nearest precision below the fp32 the
configurations state) against the fp32 reference; ``half_batch``
(training cells) runs the reference's steps on the first half of each
batch against the whole; ``float64`` (training cells) is a witness, not
a control: the program's first step and the fp32 reference's, each
against the reference computed in float64. A training control covers
both steps a run checks: the first steps from the seeded weights, and
one more step from the fp32 reference's state after them, in a run's
place the held step of the window. Prints one JSON line a seed with the
numbers a run compares. The benchmark's own runs never run this.
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def set_tf32(on):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def fwp_control(cell, seed, device, n_passes=100):
    """The forward pass's number at the TF32 reference's outputs of the
    chunks a run of ``n_passes`` passes checks."""
    from portbench import harness
    from portbench.drivers import fwp
    from portbench.reference.fwp import chunk_plan

    traffic = cell['traffic']
    work = harness.work_dir(cell['name'] + '-control', seed)
    try:
        _, arrays, topo = fwp.make_inputs(cell, seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n_chunks = len(chunk_plan(traffic['domain'], traffic['fwp_chunk_shape'],
                              0, 0)[0])
    chunks = [(p % traffic['n_files'], c) for p, c in fwp.sample_chunks(
        seed, n_passes, n_chunks, traffic)]
    set_tf32(False)
    want = fwp.reference_outputs(cell, seed, arrays, topo, chunks, device)
    set_tf32(True)
    got = fwp.reference_outputs(cell, seed, arrays, topo, chunks, device)
    set_tf32(False)
    return {'fwp_max_rel_err': fwp.max_rel_err(got, want)}


def train_batches(cell, seed, data, count):
    """``count`` batches of windows of the normalised domain, drawn from the
    seed (the control runs no program, so no feed)."""
    from portbench import harness
    from portbench.drivers import train

    traffic = cell['traffic']
    norm = train.normalize(cell['config'], data)
    rng = harness.seed_rng(seed, 5)
    shape = traffic['sample_shape']
    batches = []
    for _ in range(count):
        starts = [[int(rng.integers(0, n - w + 1))
                   for n, w in zip(norm.shape, shape)]
                  for _ in range(traffic['batch_size'])]
        batches.append(np.stack([norm[a:a + shape[0], b:b + shape[1],
                                      c:c + shape[2]]
                                 for a, b, c in starts]))
    return batches


def train_control(cell, seed, device, mode):
    """The training numbers of the control (``tf32``) or the planted
    fault (``half_batch``) against the fp32 reference, each the worse of
    the first steps and the step after them (both also given apart)."""
    from portbench import harness
    from portbench.drivers import train

    work = harness.work_dir(cell['name'] + '-control', seed)
    try:
        _, data = train.make_domain(cell, seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n = cell['traffic']['check_steps']
    batches = train_batches(cell, seed, data, n + 1)
    set_tf32(False)
    ref = train.reference(cell, seed, data, batches[:n], device)
    state = ref[3]
    ref_k = train.reference_step(cell, state, data, batches[n], device)
    if mode == 'tf32':
        set_tf32(True)
        ctl = train.reference(cell, seed, data, batches[:n], device)
        ctl_k = train.reference_step(cell, state, data, batches[n], device)
        set_tf32(False)
    else:
        ctl = train.reference(cell, seed, data,
                              [b[:len(b) // 2] for b in batches[:n]], device)
        ctl_k = train.reference_step(cell, state, data,
                                     batches[n][:len(batches[n]) // 2],
                                     device)
    n_gen = state['n_gen']
    scale = train.scales(ref, n_gen)
    losses, first, change = ctl[:3]
    steps = train.compare({'losses': losses, 'first': first,
                           'change': change}, ref, n_gen, scale,
                          'control steps')
    losses, first, change = ctl_k
    step_k = train.compare({'losses': losses, 'first': first,
                            'change': change}, ref_k, n_gen, scale,
                           'control step')
    return {**train.merge(steps, step_k),
            **{f'steps.{k}': v for k, v in steps.items()},
            **{f'step.{k}': v for k, v in step_k.items()}}


def train_float64(cell, seed, device):
    """The program's first step (as a run's set-up takes it) and the
    fp32 reference's, each against the reference in float64 on the same
    batch: where both read alike, the fp32 gaps are rounding."""
    import torch

    from portbench import harness
    from portbench.drivers import train

    work = harness.work_dir(cell['name'] + '-control', seed)
    handler = None
    set_tf32(False)
    try:
        path, data = train.make_domain(cell, seed, work)
        handler, model = train.build(cell, seed, path, device)
        prog, hr_batches = train.program_steps(
            model, iter(handler), 1, cell['traffic']['weight_gen_advers'])
        n_gen = len(model.gen_params)
        handler.stop()
        handler = None
        del model
    finally:
        if handler is not None:
            handler.stop()
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    ref32 = train.reference(cell, seed, data, hr_batches, device)
    ref32 = {'losses': ref32[0], 'first': ref32[1], 'change': ref32[2]}
    ref64 = train.reference(cell, seed, data, hr_batches, device,
                            dtype=torch.float64)
    out = {}
    scale = train.scales(ref64, n_gen)
    for name, side in (('program', prog), ('reference_fp32', ref32)):
        got = train.compare(side, ref64, n_gen, scale, f'{name} vs float64')
        out.update({f'{name}.{k}': v for k, v in got.items()})
    ref32 = (ref32['losses'], ref32['first'], ref32['change'])
    got = train.compare(prog, ref32, n_gen, train.scales(ref32, n_gen),
                        'program vs fp32')
    out.update({f'program_vs_fp32.{k}': v for k, v in got.items()})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--mode', choices=('tf32', 'half_batch', 'float64'),
                   required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness import find_cell, load_json

    cell = find_cell(load_json(ROOT / 'BENCHMARK.json'), args.workload)
    for seed in args.seeds:
        if cell['traffic']['kind'] == 'fwp':
            if args.mode != 'tf32':
                raise SystemExit(f'{args.mode} has no forward-pass form')
            readings = fwp_control(cell, seed, args.device)
        elif args.mode == 'float64':
            readings = train_float64(cell, seed, args.device)
        else:
            readings = train_control(cell, seed, args.device, args.mode)
        print(json.dumps({'workload': args.workload, 'mode': args.mode,
                          'seed': seed, 'readings': readings}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
