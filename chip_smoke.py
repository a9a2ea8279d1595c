#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``sup3r_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. environment and build: the card's name and power limit (as
   ``nvidia-smi`` gives them), then every CUDA kernel built from
   ``sup3r_tpu_torch/csrc/`` (into ``build/kernels/``);
2. each kernel against its plain PyTorch version on the card (TF32 off),
   at every shape the flagship's serving path gives it and at ragged
   ones; tolerance max|kernel - plain| <= 1e-5 * max|plain| (fp32
   accumulation order; ``reflect_conv`` runs 3xTF32 on the tensor cores,
   whose split drops ~2^-22 relative per product). ``small_reflect_conv``
   also at the shipped 8 -> 1 and 8 -> 3 tails and at the edges of its
   tiling (``SMALL_CHECKS``);
3. the main path: the flagship ``spatiotemporal/gen_3x_4x_2f`` generator
   at full width (64 filters, 16 residual blocks, seeded random
   weights) serves 3 requests of ``Sup3rGan.generate`` on a
   (16, 20, 20, 24, 2) low-res batch; the output must be finite, of
   shape (16, 60, 60, 96, 2), and ``small_reflect_conv`` must launch
   once per request. On a small input the served output is held against
   the port's unfused generator on the CPU (rtol 1e-4 of the output's
   max, the repository's fp32 parity bar);
4. the opt-in kernel path (``inference_pallas=True``): 3 more requests,
   ``reflect_conv`` launching 36 times per request, output equal to
   phase 3's within the parity bar (two fp32-accurate routes through
   37 layers);
5. one request of each path under ``torch.profiler`` (device-busy
   time, idle share, the kernels that take the time), then the
   ``kernels`` line: each kernel's time at its main-path shape
   beside its bound on this card, its plain version's time and one
   cuDNN convolution's time (a yardstick the port never calls).
   ``ms`` times the wrapper (CUDA events, weight packing and launch
   included), ``launch_ms`` the launch alone on weights packed once
   (CUDA events), ``kernel_ms`` the kernel alone (torch.profiler device
   events of its name; ``launch_ms``, and ``kernel_ms_by`` says
   ``cuda_events``, where three profiler sessions lost launches),
   ``share_of_bound`` is bound_ms / kernel_ms.
   ``reflect_conv`` also at each of its four main-path shapes,
   ``small_reflect_conv`` at the 8 -> 1, 2 and 3 tails.
6. the chunked forward pass (printed before the ``kernels`` line): a
   NetCDF3 input of (64, 64, 40) low-res cells written with the port's
   helper, the full-width flagship saved and loaded through
   ``ForwardPassStrategy`` (chunks of (16, 16, 20), pads 2, so 32 chunks
   of (20, 20, 24) padded in 2 device batches of 16), ``ForwardPass.run``
   to NetCDF output: one warm-up pass, then 3 timed passes on each route
   (wall seconds, HR voxels/s, the prep / dispatch / drain split, the
   fetched MB, the kernels' launches: ``small_reflect_conv`` once per
   dispatch, ``reflect_conv`` 36 times per dispatch on the opt-in route
   only). Every output file is read back (finite, the full (192, 192,
   160) domain tiled); on a small domain the card's per-chunk outputs
   equal the port's CPU forward pass and the batched ones the serial
   ones (the parity bar); one dispatched batch's device pack agrees
   with the host transform within one storage quantum and its stats
   with ``_output_check``.

7. training (printed before the ``kernels`` line): the gradients of
   ``small_reflect_conv``'s Function at the 8 -> 1, 2, 3 training tails
   (alpha None and 0.2) and of ``reflect_conv_ad``'s against autograd of
   their plain compositions (TF32 off; 1e-5 of the plain gradients'
   largest magnitude); one full-width flagship step at batch 2 on the
   card against the port's CPU step from the same weights, batch and
   optimizer state, for the three gating cases (losses, updated weights
   and Adam moments within 1e-4 of each tensor's largest magnitude);
   bench.py's training cell (batch 16, LR (12, 12, 12, 2), HR (36, 36,
   48, 2), Adam lr 1e-4, both networks): median step ms over 12 steps
   after 3 warm-ups (host clock, loss fetch included), HR voxels/s,
   launches per step (``small_reflect_conv`` 1, ``reflect_conv`` 0),
   peak memory; the device time of each phase of a step (CUDA events),
   one profiled step (idle share, top kernels), the small kernel's two
   cuDNN backward convs and the pads and halo folds of a step; and
   ``Sup3rGan.train`` over a ``BatchHandler`` of fake data (2 epochs of
   4 batches, validation, checkpoint reloaded, ``generate`` of the
   reloaded model).

The last line is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from sup3r_tpu_torch.configs import get_config
from sup3r_tpu_torch.models import Sup3rGan
from sup3r_tpu_torch.models.fuse import FusedReflectConv
from sup3r_tpu_torch.ops import build
from sup3r_tpu_torch.ops.output_pack import (
    fetch_stats,
    pack_chunks,
    pack_plan,
    theta_for,
)
from sup3r_tpu_torch.pipeline import ForwardPass, ForwardPassStrategy
from sup3r_tpu_torch.postprocessing import OutputHandlerH5, OutputHandlerNC
from sup3r_tpu_torch.postprocessing.writers import write_nc_file
from sup3r_tpu_torch.preprocessing import LoaderNC
from sup3r_tpu_torch.models.gan import relativistic_disc_loss
from sup3r_tpu_torch.models.weights import params_from_jax, params_to_jax
from sup3r_tpu_torch.ops.conv_ad import _fold_reflect_halos, reflect_conv_ad
from sup3r_tpu_torch.preprocessing import BatchHandler
from sup3r_tpu_torch.utilities import get_dset_attrs
from sup3r_tpu_torch.utilities.test_helpers import (
    make_fake_dset,
    make_fake_nc_file,
)
from sup3r_tpu_torch.ops.kernels import (
    pack_weights,
    reflect_conv_cf,
    reflect_conv_n_tile,
    reflect_conv_packed,
    reflect_conv_reference,
    small_conv_pack_weights,
    small_reflect_conv_cf,
    small_reflect_conv_packed,
)
from sup3r_tpu_torch.utilities import Timer, exact_fp32

#: (memory bytes/s, fp32 CUDA-core FLOP/s, dense TF32 tensor-core
#: FLOP/s) from NVIDIA's data sheets, by a substring of the card's name;
#: the H100 SXM's when none matches
PEAKS = (('H200', 4.8e12, 67e12, 495e12),
         ('H100 NVL', 3.9e12, 60e12, 417.5e12),
         ('H100 PCIe', 2.0e12, 51e12, 378e12),
         ('H100', 3.35e12, 67e12, 495e12))
REPLACES = {
    'small_reflect_conv': 'sup3r_tpu/ops/pallas_kernels.py:206',
    'reflect_conv': 'sup3r_tpu/ops/pallas_kernels.py:87',
}
SOURCES = {
    'small_reflect_conv': 'sup3r_tpu_torch/csrc/small_reflect_conv.cu',
    'reflect_conv': 'sup3r_tpu_torch/csrc/reflect_conv.cu',
}
#: each kernel's CUDA function name (held by its device events)
KERNEL_NAMES = {
    'small_reflect_conv': 'small_reflect_conv_kernel',
    'reflect_conv': 'reflect_conv_tc_kernel',
}
KERNEL_RTOL = 1e-5
PARITY_RTOL = 1e-4
LR_SHAPE = (16, 20, 20, 24, 2)
HR_SHAPE = (16, 60, 60, 96, 2)
N_REQUESTS = 3
#: fused blocks of the flagship that are not its 8 -> 2 tail
N_BODY_BLOCKS = 36
#: the flagship's fused blocks on the opt-in route: (input shape, co,
#: LeakyReLU alpha, launches per request)
BODY_SHAPES = (((16, 2, 20, 20, 24), 64, 0.2, 1),
               ((16, 64, 20, 20, 48), 64, 0.2, 1),
               ((16, 64, 20, 20, 96), 64, 0.2, 33),
               ((16, 64, 20, 20, 96), 72, 0.2, 1))
#: the HR tail's input; the flagship's tail goes to 2 channels, the
#: shipped gen_3x_4x_1f's to 1, gen_4x_24x_3f's to 3
TAIL_SHAPE = (16, 8, 60, 60, 96)
#: ``small_reflect_conv`` checks beyond the three tails without
#: LeakyReLU: (x shape, co, alpha). The kernel tiles (h, w, t) by (6, 10,
#: 32) at co <= 2 (4 and 2 rows at co = 3, 4), 4 t per thread, tensor
#: copies only for T % 4 == 0
SMALL_CHECKS = (
    (TAIL_SHAPE, 2, 0.2), (TAIL_SHAPE, 1, 0.2), (TAIL_SHAPE, 3, 0.2),
    ((2, 8, 12, 10, 33), 2, 0.2),    # T = 33: no tensor copies, ragged t
    ((2, 8, 2, 2, 40), 2, None),     # H = W = 2, the smallest that reflects
    ((1, 8, 20, 30, 64), 3, 0.2),    # B = 1
    ((2, 1, 13, 11, 40), 32, None),  # ci = 1, co = 32: eight groups
    ((2, 32, 13, 11, 40), 1, 0.2),   # ci = 32, co = 1
    ((2, 8, 13, 17, 64), 2, None),   # (H, W) the tile does not divide
    ((2, 4, 7, 5, 9), 5, 0.2),       # ragged everywhere, ci * co = 20
)


def emit(**record):
    print(json.dumps(record), flush=True)


def peaks(name):
    for key, *rates in PEAKS:
        if key in name:
            return rates
    return PEAKS[-1][1:]


def bound(name, x_shape, co, n_weights):
    """(bound_ms, bound_by, peak) of one reflect conv: each input read
    once, the output written once; 2 * taps * ci FLOP per output value.
    The lesser of two ways to do that work in fp32 accuracy: on the
    CUDA cores in fp32, or on the tensor cores as 3xTF32 (three times
    the operations at the dense TF32 rate). So the bound reads the same
    work whichever implementation runs; ``peak`` names the one that
    binds ('fp32' or 'tf32x3')."""
    bw, fp32, tf32 = peaks(name)
    n, ci, *spatial = x_shape
    cells = n * int(np.prod(spatial))
    nbytes = 4 * (cells * ci + cells * co + n_weights + co)
    ops = 2 * cells * co * ci * 3 ** len(spatial)
    t_bytes = nbytes / bw
    t, peak = min((max(t_bytes, ops / fp32), 'fp32'),
                  (max(t_bytes, 3 * ops / tf32), 'tf32x3'))
    return 1e3 * t, 'bytes' if t_bytes >= t else 'operations', peak


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after one warm-up call (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, kname, iters, attempts=3):
    """Device time of one launch of kernel ``kname`` alone, without the
    wrapper's host work and weight packing: the mean of its own device
    events under ``torch.profiler`` over ``iters`` calls of ``fn``
    (after one warm-up call). The profiler can lose a session's device
    events; None after ``attempts`` sessions that miss a launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and KERNEL_NAMES[kname] in e.key]
        launches = sum(e.count for e in events)
        total = sum(e.self_device_time_total for e in events)
        if launches == iters and total > 0:
            return total / 1e3 / iters
        print(f'{kname}: profiler session {attempt + 1} saw {launches} '
              f'launches of {iters}', file=sys.stderr, flush=True)
    return None


def conv_inputs(gen, x_shape, co, scale=1.0):
    """Seeded input, weight and bias on the card; weights scaled by
    1/sqrt(fan-in) so the outputs stay O(1)."""
    ci, n_spatial = x_shape[1], len(x_shape) - 2
    x = torch.randn(x_shape, device='cuda', generator=gen) * scale
    w = torch.randn((co, ci) + (3,) * n_spatial, device='cuda',
                    generator=gen) / np.sqrt(ci * 3 ** n_spatial)
    b = torch.randn((co,), device='cuda', generator=gen) * 0.1
    return x, w, b


def check_kernel(name, fn, x, w, b, alpha):
    """Kernel vs plain on the same inputs; returns max |diff|."""
    with torch.inference_mode(), exact_fp32():
        got = fn(x, w, b, alpha)
        want = reflect_conv_reference(x, w, b, alpha)
        torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and err <= KERNEL_RTOL * scale
    emit(phase='kernel_check', kernel=name, shape=list(x.shape),
         co=w.shape[0], alpha=alpha, max_abs_err=err, max_abs_plain=scale,
         tol=KERNEL_RTOL * scale, ok=ok)
    if not ok:
        raise AssertionError(f'{name} disagrees with its plain version at '
                             f'{tuple(x.shape)}: {err} > '
                             f'{KERNEL_RTOL} * {scale}')
    return err


def flagship(device):
    model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                     get_config('spatiotemporal/disc_test'),
                     meta={'lr_features': ['u_100m', 'v_100m'],
                           'hr_out_features': ['u_100m', 'v_100m']},
                     means={'u_100m': 0.5, 'v_100m': 0.5},
                     stdevs={'u_100m': 0.3, 'v_100m': 0.3}, device=device)
    model.init_weights((1,) + LR_SHAPE[1:], (1,) + HR_SHAPE[1:], seed=0)
    return model


def serve(model, lr, phase):
    """N_REQUESTS timed generate calls; returns the last output and the
    per-request host times (ms)."""
    times = []
    out = None
    for _ in range(N_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.generate(lr)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    if out.shape != HR_SHAPE or not np.isfinite(out).all():
        raise AssertionError(f'{phase}: output {out.shape} not finite '
                             f'{HR_SHAPE}')
    return out, times


def profile_request(model, lr):
    """One request under ``torch.profiler``: device-busy and idle share
    of the wall time, the kernels and copies that took the most device
    time (device-side events only: a CPU op's device time is its
    kernels'), and the fp32 operations of the request's fused convs
    (2 * taps * ci per output value, counted by forward hooks)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flops = []

    def count(module, args, out):
        w = module.weight
        flops.append(2 * out.numel() * w[0].numel())

    hooks = [m.register_forward_hook(count)
             for m in model._get_fused_apply().layers
             if isinstance(m, FusedReflectConv)]
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.generate(lr)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for h in hooks:
            h.remove()
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = [{'name': e.key[:90], 'calls': e.count,
            'device_ms': e.self_device_time_total / 1e3}
           for e in events[:8]]
    return wall_ms, busy_ms, top, sum(flops)


#: the forward-pass phase: low-res domain (s1, s2, t), chunk shape, pads,
#: device batch and timed passes per route
FWP_DOMAIN = (64, 64, 40)
FWP_CHUNK = (16, 16, 20)
FWP_PAD = 2
FWP_BATCH = 16
N_FWP_PASSES = 3
FWP_FEATURES = ['u_100m', 'v_100m']


class RecordedForwardPass(ForwardPass):
    """``ForwardPass`` that keeps its last instance, so a run through the
    ``ForwardPass.run`` entry point can report its timer and stats."""

    last = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        type(self).last = self


def fwp_strategy(input_file, model_dir, out_pattern, device='cuda',
                 **kwargs):
    kw = dict(file_paths=input_file,
              model_kwargs={'model_dir': model_dir, 'device': device},
              fwp_chunk_shape=FWP_CHUNK, spatial_pad=FWP_PAD,
              temporal_pad=FWP_PAD, device_batch_size=FWP_BATCH,
              out_pattern=out_pattern)
    kw.update(kwargs)
    return ForwardPassStrategy(**kw)


def check_fwp_files(strategy, out_dir):
    """Read every chunk file back through ``LoaderNC`` and tile the
    high-res domain; it must be finite and complete."""
    slicer, s_en, t_en = (strategy.fwp_slicer, strategy.s_enhance,
                          strategy.t_enhance)
    shape = (FWP_DOMAIN[0] * s_en, FWP_DOMAIN[1] * s_en,
             FWP_DOMAIN[2] * t_en, len(FWP_FEATURES))
    full = np.full(shape, np.nan, np.float32)
    for idx, path in enumerate(strategy.out_files):
        if not os.path.exists(path):
            raise AssertionError(f'forward pass: {path} was not written')
        data = LoaderNC(path).data
        s_idx, t_idx = slicer.get_chunk_indices(idx)
        s_hr = slicer.s_hr_slices[s_idx]
        t_lr = slicer.t_lr_slices[t_idx]
        full[s_hr[0], s_hr[1], t_lr.start * t_en:t_lr.stop * t_en] = \
            np.stack([data[f] for f in FWP_FEATURES], axis=-1)
    if not np.isfinite(full).all():
        raise AssertionError('forward pass: the stitched output is not '
                             f'finite and complete at {shape}')
    shutil.rmtree(out_dir)
    return list(shape[:-1])


def check_fwp_launches(route, launches, n_dispatch):
    """``small_reflect_conv`` once per dispatch on both routes,
    ``reflect_conv`` 36 times per dispatch on the opt-in route only."""
    want = {'small_reflect_conv': n_dispatch,
            'reflect_conv': (N_BODY_BLOCKS * n_dispatch
                             if route == 'opt_in' else 0)}
    if launches != want:
        raise AssertionError(f'forward pass ({route}): launches '
                             f'{launches}, expected {want}')


def fwp_pass(input_file, model_dir, out_dir, route, index):
    """One timed ``ForwardPass.run`` to NetCDF chunk files; the wall
    time includes planning (input read, strategy) and every drain."""
    small_reflect_conv_cf.launches = reflect_conv_cf.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    strategy = fwp_strategy(input_file, model_dir,
                            os.path.join(out_dir, 'chunk_{file_id}.nc'))
    plan_s = time.perf_counter() - t0
    RecordedForwardPass.run(strategy, 0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {'small_reflect_conv': small_reflect_conv_cf.launches,
                'reflect_conv': reflect_conv_cf.launches}
    fwp = RecordedForwardPass.last
    n_dispatch = -(-strategy.fwp_slicer.n_chunks // FWP_BATCH)
    check_fwp_launches(route, launches, n_dispatch)
    hr_shape = check_fwp_files(strategy, out_dir)
    hr_voxels = int(np.prod(hr_shape))
    emit(phase='forward_pass', route=route, pass_index=index,
         chunks=strategy.fwp_slicer.n_chunks, dispatches=n_dispatch,
         hr_shape=hr_shape, wall_s=wall_s, plan_s=plan_s,
         hr_voxels_per_s=hr_voxels / wall_s, timer_s=fwp.timer.log,
         stats=fwp.stats, launches=launches)
    return wall_s, launches


def fwp_profiled_pass(input_file, model_dir, out_dir, route):
    """One more pass under ``torch.profiler``: the device-busy time
    (the sum of the device events of kernels and copies, on all streams)
    against the wall time, so the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ForwardPass.run(fwp_strategy(
            input_file, model_dir,
            os.path.join(out_dir, 'chunk_{file_id}.nc')), 0)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    shutil.rmtree(out_dir)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    emit(phase='forward_pass_profile', route=route, wall_ms=wall_ms,
         device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
         top_device=[{'name': e.key[:90], 'calls': e.count,
                      'device_ms': e.self_device_time_total / 1e3}
                     for e in events[:6]])


def fwp_drain_breakdown(input_file, model_dir, tmp, repeats=10):
    """Host cost of the drain's stages for one chunk of this run's
    output shape (ms per chunk, host clock): the output check, the
    NetCDF writer's transform (limits; u/v kept) and its file write."""
    strategy = fwp_strategy(input_file, model_dir, None)
    chunk = strategy.init_chunk(0)
    s1, s2 = chunk.hr_lat_lon.shape[:2]
    data = (np.random.default_rng(3).standard_normal(
        (s1, s2, len(chunk.hr_times), len(FWP_FEATURES))) * 0.3
        + 0.5).astype(np.float32)
    out_file = os.path.join(tmp, 'breakdown.nc')
    stages = {
        'output_check': lambda: ForwardPass._output_check(data),
        'transform': lambda: OutputHandlerNC._transform_output(
            data.copy(), list(FWP_FEATURES), chunk.hr_lat_lon,
            invert_uv=False),
        'nc_write': lambda: write_nc_file(
            out_file, chunk.hr_times, chunk.hr_lat_lon[..., 0],
            chunk.hr_lat_lon[..., 1],
            {f: np.transpose(data[..., i], (2, 0, 1))
             for i, f in enumerate(FWP_FEATURES)}, meta_attr='{}'),
    }
    ms = {}
    for stage, fn in stages.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        ms[stage] = 1e3 * (time.perf_counter() - t0) / repeats
    emit(phase='forward_pass_drain_breakdown',
         chunk_hr_shape=list(data.shape), ms_per_chunk=ms,
         mb_per_file=os.path.getsize(out_file) / 2 ** 20)


def fwp_reference_checks(model_dir, tmp):
    """On a small domain: the card's per-chunk outputs against the
    port's CPU forward pass, and batched against serial on the card."""
    small = make_fake_nc_file(
        os.path.join(tmp, 'small.nc'), (8, 8, 12), FWP_FEATURES,
        data={f: np.random.default_rng(i + 5).standard_normal(
            (12, 8, 8)) * 0.3 + 0.5 for i, f in enumerate(FWP_FEATURES)})
    kw = dict(fwp_chunk_shape=(4, 4, 6), spatial_pad=1, temporal_pad=1)
    card = ForwardPass.run(fwp_strategy(small, model_dir, None,
                                        device_batch_size=4, **kw), 0)
    serial = ForwardPass.run(fwp_strategy(small, model_dir, None,
                                          device_batch_size=1, **kw), 0)
    cpu = ForwardPass.run(fwp_strategy(small, model_dir, None,
                                       device='cpu', device_batch_size=4,
                                       **kw), 0)
    for against, ref in (('cpu', cpu), ('serial', serial)):
        scale = max(float(np.abs(v).max()) for v in ref.values())
        err = max(float(np.abs(card[i] - ref[i]).max()) for i in ref)
        tol = PARITY_RTOL * scale
        ok = sorted(card) == sorted(ref) and err <= tol
        emit(phase='forward_pass_check', against=against,
             chunks=len(ref), chunk_hr_shape=list(ref[0].shape),
             max_abs_err=err, tol=tol, ok=ok)
        if not ok:
            raise AssertionError(f'forward pass: card vs {against} '
                                 f'{err} > {tol}')


def fwp_pack_check(input_file, model_dir):
    """One dispatched batch's cropped outputs packed on the card
    (``pack_chunks``, the H5 drain's device stage) against the host
    transform plus ``round(x * scale)``; the stats against
    ``_output_check``."""
    strategy = fwp_strategy(input_file, model_dir, None)
    fwp = ForwardPass(strategy, 0)
    batch = [fwp.get_input_chunk(i) for i in range(FWP_BATCH)]
    out, _, _ = fwp._dispatch_chunk_batch(batch)
    names, pairs, quant = pack_plan(FWP_FEATURES, True)
    crops = [out[i][c.hr_crop_slice] for i, c in enumerate(batch)]
    invert_lat = bool(batch[0].hr_lat_lon[-1, 0, 0]
                      > batch[0].hr_lat_lon[0, 0, 0])
    thetas = torch.as_tensor(np.stack(
        [theta_for(c.hr_lat_lon, invert_lat) for c in batch]),
        device=out.device)
    packed, stats = pack_chunks(torch.stack(crops), thetas, pairs, quant,
                                invert_lat)
    stats = fetch_stats(stats)
    packed = [p.cpu().numpy() for p in packed]
    worst = 0
    for j, (chunk, crop) in enumerate(zip(batch, crops)):
        host = crop.cpu().numpy().copy()
        ForwardPass._output_check(host)
        flat = host.reshape(-1, host.shape[-1])
        if (stats['nan_any'][j] != np.isnan(host).any()
                or list(stats['ch_const'][j]) != [
                    bool(flat[:, i].std() == 0)
                    for i in range(flat.shape[1])]
                or not np.array_equal(stats['ch_first'][j], flat[0])):
            raise AssertionError(f'pack stats of chunk {j} disagree with '
                                 '_output_check')
        data, feats = OutputHandlerH5._transform_output(
            host, list(FWP_FEATURES), chunk.hr_lat_lon, invert_uv=True)
        s1, s2, t = data.shape[:3]
        for i, name in enumerate(feats):
            attrs, dtype = get_dset_attrs(name)
            want = np.round(data[..., i].reshape(s1 * s2, t).T
                            * attrs['scale_factor']).astype(dtype)
            diff = packed[i][j].astype(np.int64) - want.astype(np.int64)
            worst = max(worst, int(np.abs(diff).max()))
    emit(phase='forward_pass_pack_check', chunks=len(batch),
         features=list(names), max_quantum_diff=worst, tol=1,
         ok=worst <= 1)
    if worst > 1:
        raise AssertionError(f'device pack differs from the host '
                             f'transform by {worst} storage quanta')


def forward_pass_phase(name):
    """Phase 6: the chunked forward pass on both routes; returns the
    kernels' launches per pass on each route."""
    tmp = tempfile.mkdtemp(prefix='chip_smoke_fwp_')
    try:
        rng = np.random.default_rng(0)
        s1, s2, t = FWP_DOMAIN
        input_file = make_fake_nc_file(
            os.path.join(tmp, 'input.nc'), FWP_DOMAIN, FWP_FEATURES,
            data={f: rng.standard_normal((t, s1, s2)) * 0.3 + 0.5
                  for f in FWP_FEATURES})
        model = flagship('cuda')
        model.meta.update(
            input_resolution={'spatial': '12km', 'temporal': '60min'})
        model_dir = os.path.join(tmp, 'model')
        model.save(model_dir)
        del model
        auto = fwp_strategy(input_file, model_dir, None,
                            device_batch_size='auto')
        ForwardPass(auto, 0)
        emit(phase='forward_pass_auto_batch',
             padded_chunk=[c + 2 * FWP_PAD for c in FWP_CHUNK],
             device_batch_size=auto.device_batch_size,
             free_gb=torch.cuda.mem_get_info()[0] / 1e9)
        served = auto.get_model()
        served.inference_pallas = False
        with Timer() as warm:
            ForwardPass.run(fwp_strategy(
                input_file, model_dir,
                os.path.join(tmp, 'warm', 'chunk_{file_id}.nc')), 0)
        emit(phase='forward_pass_warm_up', wall_s=warm.elapsed)
        per_pass = {}
        for route, pallas in (('default', False), ('opt_in', True)):
            served.inference_pallas = pallas
            walls = []
            for i in range(N_FWP_PASSES):
                wall, launches = fwp_pass(
                    input_file, model_dir,
                    os.path.join(tmp, f'{route}_{i}'), route, i)
                walls.append(wall)
            per_pass[route] = launches
            emit(phase='forward_pass_route', route=route, wall_s=walls,
                 hr_voxels_per_s=int(np.prod(FWP_DOMAIN)) * 9 * 4 / float(
                     np.median(walls)), nvidia_smi=name)
            fwp_profiled_pass(input_file, model_dir,
                              os.path.join(tmp, f'{route}_profiled'),
                              route)
        served.inference_pallas = False
        fwp_drain_breakdown(input_file, model_dir, tmp)
        fwp_reference_checks(model_dir, tmp)
        fwp_pack_check(input_file, model_dir)
        return per_pass
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: the training cell (bench.py's): batch, LR and HR shapes, Adam lr, the
#: adversarial weight; warm-up and timed steps
TRAIN_BATCH = 16
TRAIN_LR = (12, 12, 12, 2)
TRAIN_HR = (36, 36, 48, 2)
TRAIN_LR_RATE = 1e-4
W_ADV = 1e-3
N_WARM_STEPS = 3
N_TRAIN_STEPS = 12
#: the HR tail's input in a train step
TRAIN_TAIL_SHAPE = (TRAIN_BATCH, 8) + TRAIN_HR[:3]
#: the card-vs-CPU step: batch 2; Adam with epsilon 1 so that an update
#: is smooth in its gradient (with 1e-8 it is sign(g), which turns a
#: gradient entry within rounding of zero into a full +-lr either way)
CHECK_BATCH = 2
CHECK_OPT = {'name': 'Adam', 'learning_rate': TRAIN_LR_RATE, 'epsilon': 1.0}
GATES = {'both': (True, True), 'gen': (True, False), 'disc': (False, True)}


def train_model(device, optimizer=None):
    """The full-width flagship with the test discriminator, initialized
    for the training cell from seed 0."""
    model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                     get_config('spatiotemporal/disc_test'),
                     optimizer=optimizer, learning_rate=TRAIN_LR_RATE,
                     device=device)
    model.init_weights((1,) + TRAIN_LR, (1,) + TRAIN_HR, seed=0)
    return model


def leaky(x, alpha):
    """jax.nn.leaky_relu, whose gradient at 0 is 1."""
    return x if alpha is None else torch.where(x >= 0, x, alpha * x)


def grad_check(name, fn, x, w, b, alpha, dy):
    """(dx, dw, db) of ``fn`` against autograd of the plain composition
    (F.pad + cuDNN, TF32 off) on the same inputs."""
    n = x.ndim - 2
    conv = F.conv3d if n == 3 else F.conv2d
    leaves = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    plain = [t.detach().clone().requires_grad_() for t in (x, w, b)]
    with exact_fp32():
        got = torch.autograd.grad(fn(*leaves, alpha), leaves, dy)
        ref = leaky(conv(F.pad(plain[0], (1,) * 2 * n, mode='reflect'),
                         plain[1], plain[2]), alpha)
        want = torch.autograd.grad(ref, plain, dy)
    errs = {}
    ok = True
    for key, g, r in zip(('dx', 'dw', 'db'), got, want):
        err = (g - r).abs().max().item()
        tol = KERNEL_RTOL * r.abs().max().item()
        errs[key] = err
        ok = ok and bool(torch.isfinite(g).all()) and err <= tol
    emit(phase='kernel_grad_check', kernel=name, shape=list(x.shape),
         co=w.shape[0], alpha=alpha, max_abs_err=errs, ok=ok)
    if not ok:
        raise AssertionError(f'{name} gradients disagree with autograd of '
                             f'the plain composition: {errs}')
    return max(errs.values())


def kernel_grad_checks(gen):
    """Phase 7a: both Functions' gradients on the card."""
    worst = {}
    for co in (2, 1, 3):
        for alpha in (None, 0.2):
            x, w, b = conv_inputs(gen, TRAIN_TAIL_SHAPE, co)
            dy = torch.randn(x.shape[:1] + (co,) + x.shape[2:],
                             device='cuda', generator=gen)
            err = grad_check('small_reflect_conv', small_reflect_conv_cf,
                             x, w, b, alpha, dy)
            worst['small_reflect_conv'] = max(
                worst.get('small_reflect_conv', 0), err)
    for x_shape, co, alpha in (((TRAIN_BATCH, 64, 12, 12, 48), 64, 0.2),
                               ((TRAIN_BATCH, 2, 12, 12, 12), 64, 0.2),
                               ((TRAIN_BATCH, 64, 12, 12, 48), 72, None)):
        x, w, b = conv_inputs(gen, x_shape, co)
        dy = torch.randn(x.shape[:1] + (co,) + x.shape[2:], device='cuda',
                         generator=gen)
        err = grad_check('reflect_conv_ad',
                         lambda xx, ww, bb, a: reflect_conv_ad(
                             xx, ww, bb, 3, a), x, w, b, alpha, dy)
        worst['reflect_conv_ad'] = max(worst.get('reflect_conv_ad', 0), err)
    return worst


def train_batch(n, seed=1):
    """bench.py's training batch: U(0, 1) LR and HR of batch ``n``."""
    rng = np.random.default_rng(seed)
    lr = rng.random((n,) + TRAIN_LR).astype(np.float32)
    hr = rng.random((n,) + TRAIN_HR).astype(np.float32)
    return lr, hr


def step_grads(model, lr, hr):
    """Both losses' gradients (the generator's, the discriminator's) at
    one batch, computed as ``Sup3rGan._train_step`` computes them, in the
    model's dtype."""
    net = model._train_gen_net()
    dtype = model.gen_params[0].dtype
    lr = torch.as_tensor(lr, dtype=dtype, device=model.device)
    hr = torch.as_tensor(hr, dtype=dtype, device=model.device)
    with exact_fp32():
        out = net.apply(lr, {})
        d_true, d_gen = model._disc.apply(hr), model._disc.apply(out)
        gen_loss = (model.loss_fun(out, hr)
                    + W_ADV * relativistic_disc_loss(d_gen, d_true))
        disc_loss = relativistic_disc_loss(d_true, d_gen)
        return (torch.autograd.grad(gen_loss, model.gen_params,
                                    retain_graph=True),
                torch.autograd.grad(disc_loss, model.disc_params))


def rel_err(got, want, skip_last=False):
    """Largest per-tensor max|got - want| / max|want| over two tensor
    lists (on the CPU, in float64)."""
    pairs = list(zip(got, want))[:-1 if skip_last else None]
    out = 0.0
    for a, b in pairs:
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        scale = b.abs().max().item()
        out = max(out, (a - b).abs().max().item() / (scale or 1.0))
    return out


def train_check():
    """Phase 7b: one flagship step at batch 2 on the card against the
    port's CPU step from the same weights, batch and state, for the
    three gating cases. Losses within 1e-4; weights and Adam moments
    within 1e-4 of each tensor's largest magnitude, or within the step's
    fp32 conditioning where that is wider: at initialization the
    discriminator's outputs are ~1e-3 of its activations, so its
    gradients carry fp32 rounding of ~1e-3 of their size on any device.
    That conditioning is measured against a float64 step on the card:
    the card's gradients (from its Adam moments, mu = 0.1 g after one
    step) must be as close to float64 as the CPU's are (within 2x, or
    1e-4)."""
    lr, hr = train_batch(CHECK_BATCH, seed=2)
    card = train_model('cuda', CHECK_OPT)
    cpu = train_model('cpu', CHECK_OPT)
    start = [params_to_jax(card._gen), params_to_jax(card._disc)]
    ref = train_model('cuda', CHECK_OPT)
    ref._gen.double()
    ref._disc.double()
    exact = step_grads(ref, lr, hr)
    del ref
    tols, worst = {}, 0.0
    for gate, (do_gen, do_disc) in GATES.items():
        for model in (card, cpu):
            params_from_jax(model._gen, start[0])
            params_from_jax(model._disc, start[1])
            model._gen_opt_state = model._gen_tx.init(model.gen_params)
            model._disc_opt_state = model._disc_tx.init(model.disc_params)
        got = card.run_gradient_descent(lr, hr, W_ADV, do_gen, do_disc)
        want = cpu.run_gradient_descent(lr, hr, W_ADV, do_gen, do_disc)
        errs = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
        ok = all(v <= PARITY_RTOL for v in errs.values())
        conditioning = {}
        for i, tag in enumerate(('_gen', '_disc')):
            states = [getattr(m, tag + '_opt_state') for m in (card, cpu)]
            if gate == 'both':
                # fp32 against float64: the CPU's, then the card's
                e_cpu, e_card = (
                    rel_err([m / 0.1 for m in st['mu']], exact[i],
                            skip_last=tag == '_disc') for st in states)
                tols[tag] = max(PARITY_RTOL, 2 * (e_cpu + e_card))
                conditioning[tag] = {'cpu_vs_float64': e_cpu,
                                     'card_vs_float64': e_card}
                ok = ok and e_card <= max(PARITY_RTOL, 2 * e_cpu)
            nets = [getattr(m, tag) for m in (card, cpu)]
            skip = tag == '_disc'
            errs[f'param{tag}'] = rel_err(*[list(n.parameters())
                                            for n in nets], skip)
            for key in ('mu', 'nu'):
                errs[f'{key}{tag}'] = rel_err(*[st[key] for st in states],
                                              skip)
            # nu is quadratic in the gradient: twice its relative error
            ok = (ok and errs[f'param{tag}'] <= tols[tag]
                  and errs[f'mu{tag}'] <= tols[tag]
                  and errs[f'nu{tag}'] <= 2 * tols[tag])
        worst = max(worst, max(errs.values()))
        emit(phase='train_check', gate=gate, batch=CHECK_BATCH,
             losses_card=got, rel_err=errs, loss_tol=PARITY_RTOL,
             tol={k.strip('_'): v for k, v in tols.items()},
             fp32_conditioning=conditioning or None, ok=ok)
        if not ok:
            raise AssertionError(f'train step ({gate}): card vs CPU {errs}')
    return worst


def train_step_phase(name, model):
    """Phase 7c: bench.py's cell, timed; returns the launches per step."""
    lr_np, hr_np = train_batch(TRAIN_BATCH)
    lr = torch.as_tensor(lr_np, device='cuda')
    hr = torch.as_tensor(hr_np, device='cuda')
    for _ in range(N_WARM_STEPS):
        model.run_gradient_descent(lr, hr, W_ADV, True, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    small_reflect_conv_cf.launches = reflect_conv_cf.launches = 0
    times, losses = [], None
    for _ in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        losses = model.run_gradient_descent(lr, hr, W_ADV, True, True)
        times.append(1e3 * (time.perf_counter() - t0))
    launches = {'small_reflect_conv': small_reflect_conv_cf.launches,
                'reflect_conv': reflect_conv_cf.launches}
    per_step = {k: v / N_TRAIN_STEPS for k, v in launches.items()}
    ok = per_step == {'small_reflect_conv': 1, 'reflect_conv': 0} and all(
        np.isfinite(v) for v in losses.values())
    median = float(np.median(times))
    emit(phase='train_step', model='spatiotemporal/gen_3x_4x_2f',
         disc='spatiotemporal/disc_test', batch=TRAIN_BATCH,
         lr_shape=list(TRAIN_LR), hr_shape=list(TRAIN_HR),
         steps=N_TRAIN_STEPS, step_ms=times, median_step_ms=median,
         spread_ms=[float(np.min(times)), float(np.max(times))],
         hr_voxels_per_s=TRAIN_BATCH * int(np.prod(TRAIN_HR[:3]))
         / (median / 1e3), launches_per_step=per_step, losses=losses,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
         nvidia_smi=name, ok=ok)
    if not ok:
        raise AssertionError(f'train step: launches per step {per_step}, '
                             f'losses {losses}')
    return lr, hr, median, per_step


def train_phase_times(model, lr, hr):
    """Device time of each phase of one step, from CUDA events between
    the phases of a step built from the model's own calls (those of
    ``Sup3rGan._train_step``, both networks trained). The generator's
    backward runs through the discriminator to its input."""
    net = model._train_gen_net()
    gen_p, disc_p = model.gen_params, model.disc_params
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    torch.cuda.synchronize()
    with exact_fp32():
        events[0].record()
        out = net.apply(lr, {})
        events[1].record()
        d_true = model._disc.apply(hr)
        d_gen = model._disc.apply(out)
        gen_loss = (model.loss_fun(out, hr)
                    + W_ADV * relativistic_disc_loss(d_gen, d_true))
        disc_loss = relativistic_disc_loss(d_true, d_gen)
        events[2].record()
        gen_grads = torch.autograd.grad(gen_loss, gen_p, retain_graph=True)
        events[3].record()
        disc_grads = torch.autograd.grad(disc_loss, disc_p)
        events[4].record()
        model._gen_tx.update(gen_p, gen_grads, model._gen_opt_state)
        model._disc_tx.update(disc_p, disc_grads, model._disc_opt_state)
        events[5].record()
    torch.cuda.synchronize()
    names = ('gen_forward', 'disc_forward_and_losses',
             'gen_backward_through_disc', 'disc_backward',
             'optimizer_updates')
    return {k: a.elapsed_time(b)
            for k, a, b in zip(names, events[:-1], events[1:])}


def pads_and_folds_ms(model, lr):
    """Device ms per step of the fused blocks' reflect pads (one in the
    forward, one in the wgrad of the backward) and halo folds (one per
    block that needs its input's gradient), each timed alone (CUDA
    events) at the input shapes a step gives the blocks."""
    shapes = []

    def hook(module, args):
        shapes.append(tuple(args[0].shape))

    net = model._train_gen_net()
    hooks = [m.register_forward_pre_hook(hook) for m in net.layers
             if isinstance(m, FusedReflectConv)]
    try:
        with torch.no_grad(), exact_fp32():
            net.apply(lr, {})
    finally:
        for h in hooks:
            h.remove()
    pads = folds = 0.0
    for i, shape in enumerate(shapes):
        x = torch.empty(shape, device='cuda')
        padded = torch.empty(shape[:2] + tuple(d + 2 for d in shape[2:]),
                             device='cuda')
        pads += 2 * cuda_ms(lambda: F.pad(x, (1,) * 6, mode='reflect'), 5)
        if i:  # the first block's input (the LR batch) needs no gradient
            folds += cuda_ms(lambda: _fold_reflect_halos(padded, 3), 5)
    return pads, folds, len(shapes)


def tail_backward_ms():
    """The small kernel's backward convs at the training tail (co 2,
    alpha None), each timed alone (CUDA events, TF32 off): the
    full-padding dgrad with the flipped kernel and cuDNN's wgrad on the
    padded input."""
    gen = torch.Generator(device='cuda').manual_seed(5)
    x, w, _ = conv_inputs(gen, TRAIN_TAIL_SHAPE, 2)
    dy = torch.randn((TRAIN_BATCH, 2) + TRAIN_TAIL_SHAPE[2:],
                     device='cuda', generator=gen)
    xp = F.pad(x, (1,) * 6, mode='reflect')
    kf = w.flip([2, 3, 4]).transpose(0, 1)
    with exact_fp32():
        dgrad = cuda_ms(lambda: F.conv3d(dy, kf, padding=2), 20)
        wgrad = cuda_ms(lambda: torch.nn.grad.conv3d_weight(
            xp, w.shape, dy), 20)
    return {'dgrad_ms': dgrad, 'wgrad_ms': wgrad}


def train_profile(model, lr, hr):
    """One step under ``torch.profiler``: device-busy ms against the wall
    time (idle share), the small kernel's device time and the kernels
    that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.run_gradient_descent(lr, hr, W_ADV, True, True)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    small = sum(e.self_device_time_total for e in events
                if KERNEL_NAMES['small_reflect_conv'] in e.key) / 1e3
    return {'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'idle_share': 1 - busy_ms / wall_ms,
            'small_reflect_conv_ms': small,
            'top_device': [{'name': e.key[:90], 'calls': e.count,
                            'device_ms': e.self_device_time_total / 1e3}
                           for e in events[:10]]}


def train_loop(step_ms):
    """Phase 7e: ``Sup3rGan.train`` over a ``BatchHandler`` of fake
    hourly u/v data: 2 epochs of 4 batches of 16, validation, the last
    checkpoint reloaded and served."""
    features = ['u_100m', 'v_100m']
    tmp = tempfile.mkdtemp(prefix='chip_smoke_train_')
    try:
        handler = BatchHandler(
            [make_fake_dset((72, 72, 240), features)],
            [make_fake_dset((72, 72, 96), features)],
            batch_size=TRAIN_BATCH, n_batches=4, s_enhance=3, t_enhance=4,
            sample_shape=TRAIN_HR[:3])
        model = Sup3rGan(get_config('spatiotemporal/gen_3x_4x_2f'),
                         get_config('spatiotemporal/disc_test'),
                         learning_rate=TRAIN_LR_RATE)
        small_reflect_conv_cf.launches = reflect_conv_cf.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.train(handler, input_resolution={'spatial': '3km',
                                               'temporal': '60min'},
                    n_epoch=2, weight_gen_advers=W_ADV,
                    out_dir=os.path.join(tmp, 'gan_{epoch}'))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        # the tail launches once per forward: 8 train batches and 8
        # validation batches (4 of each per epoch)
        launches = {'small_reflect_conv': small_reflect_conv_cf.launches,
                    'reflect_conv': reflect_conv_cf.launches}
        t0 = time.perf_counter()
        model.calc_val_loss(handler, W_ADV)
        val_s = time.perf_counter() - t0
        handler.stop()
        history = model.history
        ok = (len(history) == 2 and all(
            c in history and np.isfinite(history[c]).all()
            for c in ('train_loss_gen', 'train_loss_disc', 'val_loss_gen',
                      'val_loss_disc')))
        loaded = Sup3rGan.load(os.path.join(tmp, 'gan_1'))
        lr = np.random.default_rng(3).standard_normal(
            (1,) + TRAIN_LR).astype(np.float32) * 0.3 + 0.5
        out = loaded.generate(lr)
        ok = (ok and out.shape == (1, 36, 36, 48, 2)
              and bool(np.isfinite(out).all())
              and len(loaded.history) == 2
              and loaded._gen_opt_state['count']
              == model._gen_opt_state['count'])
        ok = ok and launches == {'small_reflect_conv': 16,
                                 'reflect_conv': 0}
        # the epochs' seconds from the history (init and the checkpoint
        # save fall outside them); a batch's share without validation
        epoch_s = np.diff([0.0] + list(history['elapsed_time']))
        emit(phase='train_loop', epochs=2, batches_per_epoch=4,
             batch=TRAIN_BATCH, wall_s=wall_s, epoch_s=list(epoch_s),
             validation_s_per_epoch=val_s,
             s_per_batch=float(np.mean(epoch_s - val_s)) / 4,
             bare_step_s=step_ms / 1e3,
             update_fractions={k: list(history[f'train_{k}_train_frac'])
                               for k in ('gen', 'disc')},
             starvation_rate=handler._queue.starvation_rate,
             history={c: list(history[c]) for c in history.columns},
             launches=launches, reloaded_generate_shape=list(out.shape),
             ok=ok)
        if not ok:
            raise AssertionError('train loop: history, launches, reload or '
                                 'generate failed')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def training_phase(name, gen):
    """Phase 7: training on the card; returns what the kernels line
    reports of it."""
    grad_errs = kernel_grad_checks(gen)
    check_err = train_check()
    model = train_model('cuda')
    lr, hr, step_ms, per_step = train_step_phase(name, model)
    phases = train_phase_times(model, lr, hr)
    pads, folds, blocks = pads_and_folds_ms(model, lr)
    backward = tail_backward_ms()
    profile_rec = train_profile(model, lr, hr)
    emit(phase='train_profile', phase_device_ms=phases,
         pads_ms_per_step=pads, folds_ms_per_step=folds,
         fused_blocks=blocks, small_reflect_conv_backward=backward,
         **profile_rec)
    del model
    train_loop(step_ms)
    return {'launches_per_train_step': per_step['small_reflect_conv'],
            'train_backward_library_ms': backward,
            'grad_max_abs_err': grad_errs['small_reflect_conv'],
            'train_check_rel_err': check_err,
            'train_kernel_ms': profile_rec['small_reflect_conv_ms']}


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py needs a CUDA device: '
                         'torch.cuda.is_available() is False')
    # 1. environment and build
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    timer = Timer()
    with timer:
        build.build_all()
    emit(phase='build', device=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, build_s=timer.elapsed,
         build_dir=str(build.build_dir()))

    # 2. kernel vs plain
    gen = torch.Generator(device='cuda').manual_seed(0)
    tails = {co: conv_inputs(gen, TAIL_SHAPE, co) for co in (2, 1, 3)}
    body_inputs = [conv_inputs(gen, x_shape, co)
                   for x_shape, co, _, _ in BODY_SHAPES]
    body_errs = [check_kernel('reflect_conv', reflect_conv_cf, *inputs,
                              alpha)
                 for inputs, (_, _, alpha, _) in zip(body_inputs,
                                                     BODY_SHAPES)]
    tail_errs = {co: check_kernel('small_reflect_conv',
                                  small_reflect_conv_cf, *inputs, None)
                 for co, inputs in tails.items()}
    errs = {'small_reflect_conv': tail_errs[2], 'reflect_conv': body_errs[2]}
    for x_shape, co, alpha in SMALL_CHECKS:
        inputs = (tails[co] if x_shape == TAIL_SHAPE
                  else conv_inputs(gen, x_shape, co))
        check_kernel('small_reflect_conv', small_reflect_conv_cf, *inputs,
                     alpha)
    check_kernel('reflect_conv', reflect_conv_cf,
                 *conv_inputs(gen, (16, 64, 60, 60), 64), None)
    check_kernel('reflect_conv', reflect_conv_cf,
                 *conv_inputs(gen, (2, 5, 3, 7, 33), 70), 0.2)

    # 3. the main path
    model = flagship('cuda')
    lr = np.random.default_rng(0).standard_normal(LR_SHAPE).astype(
        np.float32) * 0.3 + 0.5
    torch.cuda.reset_peak_memory_stats()
    small_reflect_conv_cf.launches = reflect_conv_cf.launches = 0
    out, times = serve(model, lr, 'main path')
    launches = {'small_reflect_conv': small_reflect_conv_cf.launches}
    if launches['small_reflect_conv'] != N_REQUESTS or (
            reflect_conv_cf.launches):
        raise AssertionError(
            f'main path launches: small_reflect_conv '
            f'{small_reflect_conv_cf.launches}, reflect_conv '
            f'{reflect_conv_cf.launches}; expected {N_REQUESTS} and 0')
    hr_voxels = int(np.prod(HR_SHAPE[:-1]))
    emit(phase='main_path', model='spatiotemporal/gen_3x_4x_2f',
         filters=64, n_resblocks=16, lr_shape=list(LR_SHAPE),
         hr_shape=list(out.shape), requests=N_REQUESTS, request_ms=times,
         hr_voxels_per_s=hr_voxels / (float(np.median(times)) / 1e3),
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches={'small_reflect_conv': small_reflect_conv_cf.launches,
                   'reflect_conv': reflect_conv_cf.launches})

    # the served output against the port's unfused generator on the CPU
    small = np.random.default_rng(1).standard_normal(
        (2, 8, 8, 6, 2)).astype(np.float32) * 0.3 + 0.5
    ref_model = flagship('cpu')
    ref_model.inference_fuse = False
    ref = ref_model.generate(small)
    tol = PARITY_RTOL * float(np.abs(ref).max())
    for pallas in (False, True):
        model.inference_pallas = pallas
        err = float(np.abs(model.generate(small) - ref).max())
        emit(phase='reference_check', inference_pallas=pallas,
             shape=list(small.shape), max_abs_err=err, tol=tol,
             ok=err <= tol)
        if not err <= tol:
            raise AssertionError(f'served output differs from the CPU '
                                 f'reference by {err} > {tol}')

    # 4. the opt-in kernel path
    model.inference_pallas = True
    small_reflect_conv_cf.launches = reflect_conv_cf.launches = 0
    out_k, times_k = serve(model, lr, 'kernel path')
    launches['reflect_conv'] = reflect_conv_cf.launches
    if (reflect_conv_cf.launches != N_BODY_BLOCKS * N_REQUESTS
            or small_reflect_conv_cf.launches != N_REQUESTS):
        raise AssertionError(
            f'kernel path launches: reflect_conv '
            f'{reflect_conv_cf.launches}, small_reflect_conv '
            f'{small_reflect_conv_cf.launches}; expected '
            f'{N_BODY_BLOCKS * N_REQUESTS} and {N_REQUESTS}')
    err = float(np.abs(out_k - out).max())
    tol = PARITY_RTOL * float(np.abs(out).max())
    emit(phase='kernel_path', inference_pallas=True, requests=N_REQUESTS,
         request_ms=times_k, hr_voxels_per_s=hr_voxels / (
             float(np.median(times_k)) / 1e3),
         launches={'small_reflect_conv': small_reflect_conv_cf.launches,
                   'reflect_conv': reflect_conv_cf.launches},
         max_abs_err_vs_main_path=err, tol=tol, ok=err <= tol)
    if not err <= tol:
        raise AssertionError(f'inference_pallas output differs from the '
                             f'main path by {err} > {tol}')
    for pallas in (False, True):
        model.inference_pallas = pallas
        wall_ms, busy_ms, top, flops = profile_request(model, lr)
        emit(phase='profile', inference_pallas=pallas, wall_ms=wall_ms,
             device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
             conv_gflop=flops / 1e9,
             conv_fp32_bound_ms=1e3 * flops / peaks(name)[1],
             conv_tf32x3_bound_ms=1e3 * 3 * flops / peaks(name)[2],
             top_device=top)
    del model, out, out_k

    # 5. the kernels line, at the main-path shapes
    def timing(kname, fn, x, w, b, alpha):
        co = w.shape[0]
        with torch.inference_mode(), exact_fp32():
            ms = cuda_ms(lambda: fn(x, w, b, alpha), 20)
            if kname == 'small_reflect_conv':
                packed = small_conv_pack_weights(w)

                def bare():
                    small_reflect_conv_packed(x, packed, b, co, alpha)
            else:
                n_tile = reflect_conv_n_tile(co)
                packed = pack_weights(w, n_tile)

                def bare():
                    reflect_conv_packed(x, packed, b, co, n_tile, alpha)
            launch_ms = cuda_ms(bare, 20)
            kernel_ms = kernel_device_ms(lambda: fn(x, w, b, alpha), kname,
                                         20)
            kernel_ms_by = 'profiler'
            if kernel_ms is None:
                kernel_ms, kernel_ms_by = launch_ms, 'cuda_events'
            plain_ms = cuda_ms(
                lambda: reflect_conv_reference(x, w, b, alpha), 20)
            xp = F.pad(x, (1,) * 6, mode='reflect')
            library_ms = cuda_ms(lambda: F.conv3d(xp, w, b), 20)
        bound_ms, bound_by, peak = bound(name, tuple(x.shape), w.shape[0],
                                         w.numel())
        return {'shape': list(x.shape), 'co': w.shape[0], 'alpha': alpha,
                'ms': ms, 'launch_ms': launch_ms, 'kernel_ms': kernel_ms,
                'kernel_ms_by': kernel_ms_by, 'plain_ms': plain_ms,
                'bound_ms': bound_ms, 'bound_by': bound_by,
                'bound_peak': peak, 'share_of_bound': bound_ms / kernel_ms,
                'library_ms': library_ms}

    body_times = [timing('reflect_conv', reflect_conv_cf, *inputs, alpha)
                  for inputs, (_, _, alpha, _) in zip(body_inputs,
                                                      BODY_SHAPES)]
    shapes = [dict(t, launches_per_request=shape[3], max_abs_err=err)
              for t, shape, err in zip(body_times, BODY_SHAPES, body_errs)]

    def record(kname, times, **extra):
        return {'name': kname, 'route': 'cuda', 'source': SOURCES[kname],
                'replaces': REPLACES[kname], 'launches': launches[kname],
                'launches_per_request': launches[kname] // N_REQUESTS,
                'max_abs_err': errs[kname], **times, **extra}

    tail_times = {co: dict(timing('small_reflect_conv',
                                  small_reflect_conv_cf, *inputs, None),
                           max_abs_err=tail_errs[co])
                  for co, inputs in tails.items()}
    # 6. the chunked forward pass
    fwp_launches = forward_pass_phase(smi)
    # 7. training
    train = training_phase(smi, gen)
    train_tail = timing('small_reflect_conv', small_reflect_conv_cf,
                        *conv_inputs(gen, TRAIN_TAIL_SHAPE, 2), None)

    def per_fwp_pass(kname):
        return {route: counts[kname]
                for route, counts in fwp_launches.items()}

    kernels = [record('small_reflect_conv', tail_times[2],
                      tails=list(tail_times.values()),
                      launches_per_fwp_pass=per_fwp_pass(
                          'small_reflect_conv'),
                      launches_per_train_step=train[
                          'launches_per_train_step'],
                      train_shape=dict(
                          train_tail,
                          backward_library_ms=train[
                              'train_backward_library_ms'],
                          grad_max_abs_err=train['grad_max_abs_err'])),
               record('reflect_conv', body_times[2],
                      main_path_shapes=shapes,
                      launches_per_fwp_pass=per_fwp_pass('reflect_conv'),
                      launches_per_train_step=0)]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
