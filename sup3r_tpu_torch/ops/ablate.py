"""Ablations of ``csrc/reflect_conv.cu`` on the card: what bounds it,
and what each design choice buys.

Builds edited copies of the kernel source and times each beside the
kernel and cuDNN's fp32 convolution at the flagship's body-conv shapes,
with its max error against the plain version (relative to the plain
output's max). Copies that take work out give wrong outputs by design:

- ``no_act``: the producer skips the activation copies (weights only);
- ``no_mma``: the consumers issue no ``wgmma`` (loads and splits only);

Copies that undo one design choice compute the same function:

- ``one_a_set``: one A-fragment register set and a full wait per tap,
  in place of two sets that let a tap's loads overlap the last tap's
  ``wgmma``s;
- ``one_accumulator``: every ``wgmma`` of an output adds into one
  accumulator, with no per-stage fp32 sum;
- ``cvt_split``: activations split with ``cvt.rna.tf32.f32`` for hi and
  lo, in place of integer rounding of hi and an unrounded lo;
- ``ring3``: three stages in shared memory in place of two.

Run from the repository root on a machine with an NVIDIA H100:

    python3 -m sup3r_tpu_torch.ops.ablate

Prints the card's name and power limit, each copy's ptxas register and
spill lines, then one JSON line per shape.
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
         'uint32_t r;\n    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));'
         '\n    return r;'),
        ('l[mt][e] = __float_as_uint(v[e]', 'l[mt][e] = tf32_rna(v[e]')],
    'ring3': [('constexpr int kRing = 2;', 'constexpr int kRing = 3;')],
}
SHAPES = (((16, 64, 20, 20, 96), 64), ((16, 64, 20, 20, 96), 72))


def _build(out):
    """One nvcc per edited copy, all started together."""
    src = (build.CSRC_DIR / 'reflect_conv.cu').read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f'{name}: {old!r} not in reflect_conv.cu')
            text = text.replace(old, new)
        (out / f'{name}.cu').write_text(text)
        with open(out / f'{name}.log', 'w') as log:
            procs[name] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, '-I', str(build.CSRC_DIR),
                 '-o', str(out / f'{name}.so'), str(out / f'{name}.cu')],
                stdout=log, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        failed = proc.wait()
        log = (out / f'{name}.log').read_text()
        if failed:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        print(name, *(line.strip() for line in log.splitlines()
                      if 'Used' in line or 'spill' in line), sep='\n  ')
        fn = ctypes.CDLL(str(out / f'{name}.so')).reflect_conv_tf32x3
        fn.argtypes = tk._SIGNATURES['reflect_conv_tf32x3']
        fns[name] = fn
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


def main():
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    out = build.BUILD_ROOT / 'ablate'
    out.mkdir(parents=True, exist_ok=True)
    fns = _build(out)
    gen = torch.Generator(device='cuda').manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for x_shape, co in SHAPES:
        x = torch.randn(x_shape, device='cuda', generator=gen)
        w = torch.randn((co, x_shape[1], 3, 3, 3), device='cuda',
                        generator=gen) / np.sqrt(27 * x_shape[1])
        b = torch.randn((co,), device='cuda', generator=gen) * 0.1
        n_tile = tk.reflect_conv_n_tile(co)
        wp = tk.pack_weights(w, n_tile)
        y = torch.empty((x_shape[0], co, *x_shape[2:]), device='cuda')
        with torch.inference_mode(), exact_fp32():
            xp = F.pad(x, (1,) * 6, mode='reflect')
            rec = {'shape': list(x_shape), 'co': co,
                   'cudnn_ms': _ms(lambda: F.conv3d(xp, w, b))}
            want = tk.reflect_conv_reference(x, w, b, 0.2)
        scale = want.abs().max().item()
        for name, fn in fns.items():
            def call():
                err = fn(x.data_ptr(), wp.data_ptr(), b.data_ptr(),
                         y.data_ptr(), 3, x_shape[0], x_shape[1], co,
                         *x_shape[2:], n_tile, 1, 0.2, 0, stream)
                if err:
                    raise RuntimeError(f'{name}: CUDA error {err}')
            rec[f'{name}_ms'] = _ms(call)
            rec[f'{name}_err'] = (y - want).abs().max().item() / scale
        print(json.dumps(rec), flush=True)


if __name__ == '__main__':
    main()
