"""Ablations of the port's CUDA kernels on the card: what bounds each,
and what each design choice buys.

Builds edited copies of each kernel source (``EDITS``, per source) and
times each beside the kernel and cuDNN's fp32 convolution at the
flagship's shapes (``SHAPES``), with its max error against the plain
version (relative to the plain output's max). Copies that take work out
give wrong outputs by design; copies that undo one design choice
compute the same function.

``csrc/reflect_conv.cu``, at the body conv x (16, 64, 20, 20, 96) -> 64
and -> 72:

- ``no_act``: the producer skips the activation copies (weights only);
- ``no_mma``: the consumers issue no ``wgmma`` (loads and splits only);
- ``one_a_set``: one A-fragment register set and a full wait per tap,
  in place of two sets that let a tap's loads overlap the last tap's
  ``wgmma``s;
- ``one_accumulator``: every ``wgmma`` of an output adds into one
  accumulator, with no per-stage fp32 sum;
- ``cvt_split``: activations split with ``cvt.rna.tf32.f32`` for hi and
  lo, in place of integer rounding of hi and an unrounded lo;
- ``ring3``: three stages in shared memory in place of two.

``csrc/small_reflect_conv.cu``, at the shipped tails x (16, 8, 60, 60,
96) -> 2 (the flagship's), -> 1 and -> 3, and at 88 batch items -> 2
(30 full waves of resident blocks against the flagship's 5.45: beside
the flagship's time, what a batch item costs once the kernel's ramp-up
and drain are spread over many):

- ``no_fma``: no FMAs (staging, waits and stores only);
- ``no_stage``: no copies into shared memory (FMAs on whatever the
  stages hold, and stores);
- ``fma_only``: neither copies nor shared-memory reads of the input
  (FMAs, weight reads and stores);
- ``no_edge``: no reads of the two edge cells (t - 1 and t + 4) of a
  thread's lines, the 4-way bank-conflicted scalar loads;
- ``no_store``: no output stores;
- ``cp_async``: the 4-byte cp.async staging (the path for T % 4 != 0)
  in place of one tensor copy per channel;
- ``tw20``: tiles 20 w wide in blocks of 320 threads, two resident per
  SM, in place of 10 w in blocks of 160, four per SM (less halo, more
  warps held at each barrier).

Run from the repository root on a machine with an NVIDIA H100:

    python3 -m sup3r_tpu_torch.ops.ablate

Prints the card's name and power limit, each copy's ptxas register and
spill lines, then one JSON line per source and shape.
"""

import ctypes
import json
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from sup3r_tpu_torch.ops import build
from sup3r_tpu_torch.ops import kernels as tk
from sup3r_tpu_torch.utilities import exact_fp32

EDITS = {
    'reflect_conv': {
        'kernel': [],
        'no_act': [('for (int p = pt; p < kKC * n_lines; p += kProducers) {',
                    'for (int p = pt; p < 0; p += kProducers) {')],
        'no_mma': [('Wgmma<NT>::run(', 'if (g.CI < 0) Wgmma<NT>::run(')],
        'one_a_set': [
            ('uint32_t ah[2][MT][4], al[2][MT][4];',
             'uint32_t ah[1][MT][4], al[1][MT][4];'),
            ('= ah[tap & 1];', '= ah[0];'), ('= al[tap & 1];', '= al[0];'),
            ('wgmma.wait_group.sync.aligned 1;',
             'wgmma.wait_group.sync.aligned 0;')],
        'one_accumulator': [('bh, tap > 0);', 'bh, 1);'),
                            ('sum[mt][i] += acc[mt][i];',
                             'sum[mt][i] = acc[mt][i];')],
        'cvt_split': [
            ('return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;',
             'uint32_t r;\n    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : '
             '"f"(v));\n    return r;'),
            ('l[mt][e] = __float_as_uint(v[e]', 'l[mt][e] = tf32_rna(v[e]')],
        'ring3': [('constexpr int kRing = 2;', 'constexpr int kRing = 3;')],
    },
    'small_reflect_conv': {
        'kernel': [],
        'no_fma': [('acc[o][j][c] = fmaf(v[j + dt],', 'fmaf(v[j + dt],')],
        'no_stage': [('ci < CI; ++ci) stage(ci);', 'ci < 0; ++ci) stage(ci);'),
                     ('if (ci + kStages - 1 < CI) stage(ci + kStages - 1);',
                      ''),
                     ('mbar_wait(&full[ci % kStages], (ci / kStages) & 1);',
                      '')],
        'fma_only': [('ci < CI; ++ci) stage(ci);', 'ci < 0; ++ci) stage(ci);'),
                     ('if (ci + kStages - 1 < CI) stage(ci + kStages - 1);',
                      ''),
                     ('mbar_wait(&full[ci % kStages], (ci / kStages) & 1);',
                      ''),
                     ('*reinterpret_cast<const float4*>(p + 4 + 4 * q);',
                      'make_float4(wv[0][q], wv[1][q], wv[2][q], wv[0][0]);'),
                     ('v[0] = p[e0];', 'v[0] = wv[1][0];'),
                     ('v[kRT + 1] = p[e1];', 'v[kRT + 1] = wv[2][1];')],
        'no_edge': [('v[0] = p[e0];', 'v[0] = 0.f;'),
                    ('v[kRT + 1] = p[e1];', 'v[kRT + 1] = v[1] * v[2];')],
        'no_store': [('if (w >= W || t >= T) return;',
                      'if (w >= W || t >= T || acc[0][0][0] != 1.5f) return;')],
        'cp_async': [('const int bulk = T % 4 == 0', 'const int bulk = 0')],
        'tw20': [('constexpr int kTW = 10;', 'constexpr int kTW = 20;'),
                 ('constexpr int kMinBlocks = 4;',
                  'constexpr int kMinBlocks = 2;')],
    },
}
#: (x shape, co, LeakyReLU alpha) each source is timed at
SHAPES = {
    'reflect_conv': (((16, 64, 20, 20, 96), 64, 0.2),
                     ((16, 64, 20, 20, 96), 72, 0.2)),
    'small_reflect_conv': (((16, 8, 60, 60, 96), 2, None),
                           ((16, 8, 60, 60, 96), 1, None),
                           ((16, 8, 60, 60, 96), 3, None),
                           ((88, 8, 60, 60, 96), 2, None)),
}
#: each source's C entry point
ENTRY = {
    'reflect_conv': 'reflect_conv_tf32x3',
    'small_reflect_conv': 'small_reflect_conv_f32',
}


def _build(out):
    """One nvcc per edited copy of each source, all started together;
    returns ``{(source, copy): C entry point}``."""
    texts = {}
    for source, edits in EDITS.items():
        src = (build.CSRC_DIR / f'{source}.cu').read_text()
        for name, pairs in edits.items():
            text = src
            for old, new in pairs:
                if old not in text:
                    raise RuntimeError(f'{name}: {old!r} not in {source}.cu')
                text = text.replace(old, new)
            texts[source, name] = text
    procs = {}
    for (source, name), text in texts.items():
        stem = f'{out}/{source}-{name}'
        with open(f'{stem}.cu', 'w') as f:
            f.write(text)
        with open(f'{stem}.log', 'w') as log:
            procs[source, name] = (stem, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, '-I', str(build.CSRC_DIR),
                 '-o', f'{stem}.so', f'{stem}.cu'],
                stdout=log, stderr=subprocess.STDOUT))
    fns = {}
    for (source, name), (stem, proc) in procs.items():
        failed = proc.wait()
        with open(f'{stem}.log') as f:
            log = f.read()
        if failed:
            raise RuntimeError(f'nvcc failed for {source} {name}:\n{log}')
        print(source, name, *(line.strip() for line in log.splitlines()
                              if 'Used' in line or 'spill' in line),
              sep='\n  ')
        fn = getattr(ctypes.CDLL(f'{stem}.so'), ENTRY[source])
        fn.argtypes = tk._SIGNATURES[ENTRY[source]]
        fns[source, name] = fn
    return fns


def _ms(fn, iters=20):
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


def _launcher(source, x, w, b, y, alpha):
    """(packed weights, the entry point's arguments after the four
    tensors) of one launch of ``source``."""
    stream = torch.cuda.current_stream().cuda_stream
    n, ci, *spatial = x.shape
    co = w.shape[0]
    tail = (alpha is not None, 0.0 if alpha is None else alpha, 0, stream)
    if source == 'reflect_conv':
        n_tile = tk.reflect_conv_n_tile(co)
        return (tk.pack_weights(w, n_tile),
                (3, n, ci, co, *spatial, n_tile, *tail))
    return tk.small_conv_pack_weights(w), (n, ci, *spatial, co, *tail)


def main():
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    out = build.BUILD_ROOT / 'ablate'
    out.mkdir(parents=True, exist_ok=True)
    fns = _build(out)
    gen = torch.Generator(device='cuda').manual_seed(0)
    for source, shapes in SHAPES.items():
        for x_shape, co, alpha in shapes:
            x = torch.randn(x_shape, device='cuda', generator=gen)
            w = torch.randn((co, x_shape[1], 3, 3, 3), device='cuda',
                            generator=gen) / np.sqrt(27 * x_shape[1])
            b = torch.randn((co,), device='cuda', generator=gen) * 0.1
            y = torch.empty((x_shape[0], co, *x_shape[2:]), device='cuda')
            wp, args = _launcher(source, x, w, b, y, alpha)
            with torch.inference_mode(), exact_fp32():
                xp = F.pad(x, (1,) * 6, mode='reflect')
                rec = {'source': source, 'shape': list(x_shape), 'co': co,
                       'alpha': alpha,
                       'cudnn_ms': _ms(lambda: F.conv3d(xp, w, b))}
                want = tk.reflect_conv_reference(x, w, b, alpha)
            scale = want.abs().max().item()
            for (src, name), fn in fns.items():
                if src != source:
                    continue

                def call():
                    err = fn(x.data_ptr(), wp.data_ptr(), b.data_ptr(),
                             y.data_ptr(), *args)
                    if err:
                        raise RuntimeError(f'{name}: CUDA error {err}')
                rec[f'{name}_ms'] = _ms(call)
                rec[f'{name}_err'] = (y - want).abs().max().item() / scale
            print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
