// Weight gradient of a reflect-pad-1 + k3/s1 3D convolution, fp32 in and
// out, as a split-K GEMM on the tensor cores in 3xTF32:
//
//     dW[co, ci, tap] = sum over (n, cell) of dy[n, co, cell]
//                       * x[n, ci, reflect(cell + tap - 1)]
//
// for the generator's fused blocks in training (the backward of
// sup3r_tpu_torch/ops/conv_ad.py::ReflectConvAD and of the small kernel).
//
// Replaces no Pallas kernel: the JAX package leaves this weight gradient
// to XLA's native conv wgrad (sup3r_tpu/ops/conv_ad.py). It takes the
// place of cuDNN's fp32 wgrad on a reflect-padded copy of x
// (torch.nn.grad.conv3d_weight), which ran the train step's body blocks at
// a few percent of the card's rate and its 8 -> 2 tail three orders of
// magnitude above its byte bound.
//
// Bound on an H100 SXM: operations. One flagship body block, x (16, 64,
// 24, 24, 72) and dy (16, 64, ...), is 146.8 GFLOP against ~340 MB of
// traffic (~0.10 ms at 3.35 TB/s): 2.19 ms on the CUDA cores in fp32 at 67
// TFLOP/s, 0.89 ms as three TF32 products on the tensor cores at 495
// TFLOP/s. The 8 -> 2 tail at (16, 8, 72, 72, 72) is bound by its ~240 MB
// of bytes (~0.07 ms).
//
// Numerics, as in reflect_conv.cu: each operand v splits into hi =
// tf32(v), rounded to nearest with ties away, and lo = v - hi; every
// K-step issues lo*hi, hi*lo and hi*hi. The tensor cores add into their
// accumulator with truncation, so the products of kFlush K-steps go to a
// fresh accumulator that is then added to an fp32 sum (round to nearest):
// at 12 K-steps a sum, the blocks of 2 or 3 input channels carried up to
// 1.43 times cuDNN fp32's error against float64, at 3 at most 0.82 times,
// for ~3% of the body's time. The split-K partial sums are added in a
// fixed order by a second pass: no float atomics, so equal inputs give
// bit-equal dW.
//
// Design. GEMM view: M = (ci, tap) rows, ci-major (row = ci * 27 + tap),
// N = output channels, K = output cells (n, s0, s1, s2).
// - A (x) is read from registers: each consumer thread loads its rows'
//   values straight from a staged tile of x that carries a reflect halo on
//   every side (made by index math, as reflect_conv.cu does), so each of
//   the 27 taps is a constant offset into the tile; no padded copy of x
//   and no im2col is written. The values are split to hi / lo in
//   registers.
// - B (dy) is read by wgmma from shared memory. A pre-pass
//   (wgrad_pack_kernel) writes dy once as TF32 hi / lo halves in wgmma's
//   K-major core-matrix order, stage by stage, so a stage's dy is one bulk
//   (TMA) copy; output channels below the N tile (co < 8) are padded with
//   zero rows in shared memory only.
// - A stage is nl lines x TT cells of one (n, s0) plane, each line padded
//   to a multiple of 4 cells (kMaxCells cells at most: the cells of a
//   K-step never straddle a line). A thread block owns kRows = 256 rows of
//   M (two consumer warpgroups of two 64-row tiles, the channels they
//   touch staged: 11 at most) and one N tile, and walks a contiguous run
//   of stages (split-K over the planes); one producer warpgroup fills a
//   ring of stages (cp.async for x, a bulk copy for dy, both completing on
//   the stage's mbarrier).
// - Each block writes its partial (256 rows x N tile) to scratch;
//   wgrad_reduce_kernel adds the partials of every K split in order.
// Scratch (the packed dy and the partials) comes from the wrapper
// (sup3r_tpu_torch/ops/kernels.py::reflect_conv_wgrad), sized by
// reflect_conv_wgrad_scratch.

#include <cstdint>

#include "common.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kConsumers = 256;             // two warpgroups
constexpr int kProducers = 128;             // and one producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kMT = 2;                      // 64-row tiles a warpgroup
constexpr int kRows = 2 * kMT * 64;         // M rows a block
constexpr int kTaps = 27;
constexpr int kMaxGroups = 12;              // K-steps (8 cells) a stage
constexpr int kMaxCells = 8 * kMaxGroups;
constexpr int kFlush = 3;                   // K-steps a fresh accumulator
constexpr int kMaxRing = 3;
constexpr int kSmemMax = 232448;            // 227 KB a block may use
constexpr int kBarBytes = 128;
constexpr int kOff = 4;                     // staged column of t0 (16 B)
constexpr int kMaxChannels = (kRows - 1) / kTaps + 2;  // 11

struct Geom {
    int B, CI, CO, S0, S1, S2;
    int TT, TT4, nt2;   // t tile, its width rounded up to 4, t tiles
    int nl, nlb;        // lines a stage, line blocks a plane
    int NG;             // K-steps a stage
    int LS, PS, CS;     // staged line, plane and channel strides (floats)
    int CHS;            // channels staged
    int NT, n_tiles;    // N tile, N tiles
    int x_floats, stage_floats, ring, smem;
    int n_stages, m_groups, k_splits;
    int vec;
};

int round4(int v) { return (v + 3) & ~3; }

int n_tile_for(int co) {
    return co <= 8 ? 8 : co <= 16 ? 16 : co <= 32 ? 32 : co <= 64 ? 64
        : co <= 72 ? 72 : 64;
}

// The launch geometry; false where no stage fits in shared memory.
bool plan(Geom& g, int B, int CI, int CO, int S0, int S1, int S2, int sms) {
    g.B = B; g.CI = CI; g.CO = CO; g.S0 = S0; g.S1 = S1; g.S2 = S2;
    const int n2 = (S2 + kMaxCells - 1) / kMaxCells;
    g.TT = n2 == 1 ? S2 : round4((S2 + n2 - 1) / n2);
    g.nt2 = (S2 + g.TT - 1) / g.TT;
    g.TT4 = round4(g.TT);
    g.NT = n_tile_for(CO);
    g.n_tiles = (CO + g.NT - 1) / g.NT;
    g.CHS = CI < kMaxChannels ? CI : kMaxChannels;
    // Line stride: the halo'd line (TT4 + 2 columns from kOff - 1), 8 or
    // 24 (mod 32) words, so the lines of a warp's taps fall in distinct
    // banks.
    g.LS = round4(g.TT4 + kOff + 1);
    while (g.LS % 32 != 8 && g.LS % 32 != 24) g.LS += 4;
    int nl = kMaxCells / g.TT4;
    nl = nl < 1 ? 1 : nl > S1 ? S1 : nl;
    for (; nl >= 1; --nl) {
        g.nl = nl;
        g.NG = (nl * g.TT4 + 7) / 8;
        g.PS = (nl + 2) * g.LS;
        g.CS = 3 * g.PS;
        g.x_floats = g.CHS * g.CS;
        g.stage_floats = g.x_floats + g.NG * 16 * g.NT;
        for (g.ring = kMaxRing; g.ring >= 2; --g.ring) {
            g.smem = kBarBytes + g.ring * 4 * g.stage_floats;
            if (g.smem <= kSmemMax) break;
        }
        if (g.ring >= 2) break;
    }
    if (nl < 1) return false;
    g.nlb = (S1 + g.nl - 1) / g.nl;
    const long long stages = (long long)B * S0 * g.nlb * g.nt2;
    if (stages > 0x7fffffffll) return false;
    g.n_stages = (int)stages;
    g.m_groups = (kTaps * CI + kRows - 1) / kRows;
    const int blocks = g.m_groups * g.n_tiles;
    int k_splits = sms / blocks;
    k_splits = k_splits < 1 ? 1 : k_splits;
    g.k_splits = k_splits < g.n_stages ? k_splits : g.n_stages;
    // 16-byte copies along t (the launch also needs x 16-byte aligned)
    g.vec = S2 % 4 == 0 && g.TT % 4 == 0 && S2 % g.TT == 0;
    return g.m_groups <= 65535 && g.k_splits <= 65535 && g.n_tiles <= 65535;
}

long long packed_floats(const Geom& g) {
    return (long long)g.n_stages * g.NG * 16 * g.CO;
}

long long partial_floats(const Geom& g) {
    return (long long)g.k_splits * g.n_tiles * g.m_groups * kRows * g.NT;
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ uint64_t desc_b(const float* p, int lbo) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
        | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Stage index -> (n, s0, first line, first t) of its cells.
struct StageAt {
    int b, s0, l0, t0;
    __device__ StageAt(const Geom& g, int st) {
        const int tt = st % g.nt2;
        st /= g.nt2;
        const int lb = st % g.nlb;
        st /= g.nlb;
        s0 = st % g.S0;
        b = st / g.S0;
        l0 = lb * g.nl;
        t0 = tt * g.TT;
    }
};

// dy (B, CO, S0, S1, S2) -> per stage, per K-step j: [hi, lo][k-half]
// [CO][4 cells] TF32 values; cells outside the plane or the t tile are 0.
// One thread a (stage, co, group of 4 cells), both halves.
__global__ void wgrad_pack_kernel(const float* __restrict__ dy,
                                  float4* __restrict__ pk, const Geom g) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int groups = 2 * g.NG;
    const long long total = (long long)g.n_stages * g.CO * groups;
    if (idx >= total) return;
    const int gi = (int)(idx % groups);
    const long long rest = idx / groups;
    const int co = (int)(rest % g.CO);
    const int st = (int)(rest / g.CO);
    const StageAt at(g, st);
    const int q4 = g.TT4 / 4;
    const int line = gi / q4;
    const int c = (gi % q4) * 4;
    const int l = at.l0 + line;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (gi < g.nl * q4 && l < g.S1) {
        const float* src = dy + ((((long long)at.b * g.CO + co) * g.S0
                                  + at.s0) * g.S1 + l) * g.S2 + at.t0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (c + e < g.TT && at.t0 + c + e < g.S2) v[e] = src[c + e];
    }
    float hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        hi[e] = __uint_as_float(tf32_rna(v[e]));
        lo[e] = __uint_as_float(tf32_rna(v[e] - hi[e]));
    }
    const long long base = ((long long)st * g.NG + gi / 2) * 4 * g.CO;
    const int kh = gi % 2;
    pk[base + kh * g.CO + co] = make_float4(hi[0], hi[1], hi[2], hi[3]);
    pk[base + (2 + kh) * g.CO + co] = make_float4(lo[0], lo[1], lo[2], lo[3]);
}

// The producer warpgroup: per stage, thread 0 sends the stage's packed dy
// (one bulk copy, or one a (K-step, half, k-half) when the N tile holds
// fewer channels than it is wide), and the threads copy the staged x
// tile, one (channel, plane, line) each, with cp.async.
template <int NT>
__device__ __forceinline__ void produce(const float* __restrict__ x,
                                        const float* __restrict__ pk,
                                        float* ring, uint64_t* full,
                                        uint64_t* empty, const Geom g,
                                        int c_first, int nb, int st_begin,
                                        int st_end) {
    const int pt = threadIdx.x - kConsumers;
    const int cot = min(NT, g.CO - nb * NT);
    const int dy_bytes = g.NG * 4 * cot * 16;
    const int lines_per_plane = g.nl + 2;
    const int lines = g.CHS * 3 * lines_per_plane;
    const long long plane = (long long)g.S1 * g.S2;
    const long long chan = (long long)g.S0 * plane;
    for (int st = st_begin, i = 0; st < st_end; ++st, ++i) {
        const int s = i % g.ring;
        if (i >= g.ring) mbar_wait(&empty[s], (i / g.ring - 1) & 1);
        float* act = ring + s * g.stage_floats;
        float* dyt = act + g.x_floats;
        const StageAt at(g, st);
        if (pt == 0) {
            mbar_expect_tx(&full[s], dy_bytes);
            const float* src = pk + (long long)st * g.NG * 16 * g.CO;
            if (cot == g.CO && cot == NT) {
                bulk_copy(dyt, src, dy_bytes, &full[s]);
            } else {
                for (int u = 0; u < g.NG * 4; ++u)
                    bulk_copy(dyt + u * NT * 4,
                              src + ((long long)u * g.CO + nb * NT) * 4,
                              cot * 16, &full[s]);
            }
        }
        for (int p = pt; p < lines; p += kProducers) {
            const int ch = p / (3 * lines_per_plane);
            const int r = p - ch * 3 * lines_per_plane;
            const int pl = r / lines_per_plane;
            const int li = r - pl * lines_per_plane;
            // Channels past CI copy channel CI - 1: their rows are dead.
            const float* src = x
                + ((long long)at.b * g.CI + min(c_first + ch, g.CI - 1)) * chan
                + (long long)reflect1(at.s0 + pl - 1, g.S0) * plane
                + (long long)reflect1(at.l0 - 1 + li, g.S1) * g.S2;
            // column q of the staged line holds t0 - 1 + q
            float* dst = act + ch * g.CS + pl * g.PS + li * g.LS + kOff - 1;
            if (g.vec) {
                for (int j = 0; j < g.TT; j += 4)
                    cp_async16(dst + 1 + j, src + at.t0 + j);
                cp_async4(dst, src + reflect1(at.t0 - 1, g.S2));
                cp_async4(dst + g.TT + 1, src + reflect1(at.t0 + g.TT, g.S2));
            } else {
                for (int q = 0; q < g.TT4 + 2; ++q)
                    cp_async4(dst + q, src + reflect1(at.t0 - 1 + q, g.S2));
            }
        }
        cp_async_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The two consumer warpgroups: the GEMM over the block's stages, then its
// partial sums to scratch.
template <int NT>
__device__ __forceinline__ void consume(const float* ring, uint64_t* full,
                                        uint64_t* empty,
                                        float* __restrict__ partial,
                                        const Geom g, int grp, int ks, int nb,
                                        int c_first, int st_begin,
                                        int st_end) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int gr = lane >> 2;
    const int tq = lane & 3;
    const int M = kTaps * g.CI;

    // Each thread's A rows: (warpgroup tile, 16-row warp slice, lane / 4,
    // + 8) -> the staged offset of (channel, tap). Rows past M read the
    // tile's first cells and are never reduced.
    int row_off[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = grp * kRows + ((warp >> 2) * kMT + mt) * 64
                + (warp & 3) * 16 + gr + 8 * h;
            int off = kOff - 1;
            if (r < M) {
                const int ci = r / kTaps;
                const int tap = r - ci * kTaps;
                off += (ci - c_first) * g.CS + (tap / 9) * g.PS
                    + (tap / 3 % 3) * g.LS + tap % 3;
            }
            row_off[mt][h] = off;
        }
    const int q4 = g.TT4 / 4;
    const int valid_groups = g.nl * q4;

    float sum[kMT][NT / 2], acc[kMT][NT / 2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) sum[mt][i] = acc[mt][i] = 0.f;
    // One A register set, and a full wait per K-step: two sets (a step's
    // loads overlapping the last step's wgmmas, as reflect_conv.cu has
    // it) left too few registers, ptxas serialized the wgmmas, and the
    // kernel was 8-15% slower.
    uint32_t hr[kMT][4], lr[kMT][4];

    for (int st = st_begin, i = 0; st < st_end; ++st, ++i) {
        const int s = i % g.ring;
        mbar_wait(&full[s], (i / g.ring) & 1);
        const float* act = ring + s * g.stage_floats + tq;
        const float* dyt = ring + s * g.stage_floats + g.x_floats;
        // the staged offset of the next group of 4 cells
        int gline = 0, gcol = 0;
#pragma unroll
        for (int j = 0; j < kMaxGroups; ++j) {
            if (j < g.NG) {
                int o[2];
#pragma unroll
                for (int kh = 0; kh < 2; ++kh) {
                    o[kh] = 2 * j + kh < valid_groups ? gline + gcol : 0;
                    gcol += 4;
                    if (gcol == g.TT4) {
                        gcol = 0;
                        gline += g.LS;
                    }
                }
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                    // a0 (row, k), a1 (row + 8, k), a2 (row, k + 4),
                    // a3 (row + 8, k + 4), k = lane % 4
                    const float v[4] = {act[row_off[mt][0] + o[0]],
                                        act[row_off[mt][1] + o[0]],
                                        act[row_off[mt][0] + o[1]],
                                        act[row_off[mt][1] + o[1]]};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        hr[mt][e] = tf32_rna(v[e]);
                        lr[mt][e] = __float_as_uint(
                            v[e] - __uint_as_float(hr[mt][e]));
                    }
                }
                const float* bt = dyt + j * 16 * NT;
                const uint64_t bh = desc_b(bt, 16 * NT);
                const uint64_t bl = desc_b(bt + 8 * NT, 16 * NT);
                asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                    Wgmma<NT>::run(acc[mt], lr[mt], bh, j % kFlush != 0);
                    Wgmma<NT>::run(acc[mt], hr[mt], bl, 1);
                    Wgmma<NT>::run(acc[mt], hr[mt], bh, 1);
                }
                asm volatile("wgmma.commit_group.sync.aligned;\n"
                             ::: "memory");
                asm volatile("wgmma.wait_group.sync.aligned 0;\n"
                             ::: "memory");
                if (j % kFlush == kFlush - 1 || j == g.NG - 1) {
#pragma unroll
                    for (int mt = 0; mt < kMT; ++mt) {
                        fence_regs(acc[mt]);
#pragma unroll
                        for (int e = 0; e < NT / 2; ++e)
                            sum[mt][e] += acc[mt][e];
                    }
                }
            }
        }
        mbar_arrive(&empty[s]);
    }

    float* out = partial
        + (((long long)ks * g.n_tiles + nb) * g.m_groups + grp) * kRows * NT;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = ((warp >> 2) * kMT + mt) * 64 + (warp & 3) * 16
                + gr + 8 * h;
#pragma unroll
            for (int j = 0; j < NT / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    out[r * NT + 8 * j + 2 * tq + e] =
                        sum[mt][4 * j + 2 * h + e];
        }
}

// x (B, CI, S0, S1, S2); pk from wgrad_pack_kernel; partial (k splits, N
// tiles, M groups, kRows, NT).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
reflect_conv_wgrad_kernel(const float* __restrict__ x,
                          const float* __restrict__ pk,
                          float* __restrict__ partial, const Geom g) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + kMaxRing;
    float* ring = reinterpret_cast<float*>(smem + kBarBytes);
    const int grp = blockIdx.x;
    const int ks = blockIdx.y;
    const int nb = blockIdx.z;
    const int st_begin = (int)((long long)ks * g.n_stages / g.k_splits);
    const int st_end = (int)((long long)(ks + 1) * g.n_stages / g.k_splits);
    const int c_first = grp * kRows / kTaps;

    if (threadIdx.x == 0) {
        for (int s = 0; s < g.ring; ++s) {
            mbar_init(&full[s], kProducers + 1);
            mbar_init(&empty[s], kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // An N tile wider than its channels reads zero rows past them; they
    // are written here once and never copied over.
    const int cot = min(NT, g.CO - nb * NT);
    if (cot < NT) {
        const int pad = (NT - cot) * 4;
        const int n = g.ring * g.NG * 4 * pad;
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int u = i / pad;
            const int s = u / (g.NG * 4);
            ring[s * g.stage_floats + g.x_floats + (u % (g.NG * 4)) * NT * 4
                 + cot * 4 + i % pad] = 0.f;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();

    const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (warpgroup == kConsumers / 128) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        produce<NT>(x, pk, ring, full, empty, g, c_first, nb, st_begin,
                    st_end);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        consume<NT>(ring, full, empty, partial, g, grp, ks, nb, c_first,
                    st_begin, st_end);
    }
}

// dw (CO, CI, 27) = the partials of every K split, added in order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dw, const Geom g) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    const int rows = kTaps * g.CI;
    if (idx >= g.CO * rows) return;
    const int co = idx / rows;
    const int row = idx - co * rows;
    const int nb = co / g.NT;
    const int grp = row / kRows;
    const long long stride = (long long)g.n_tiles * g.m_groups * kRows * g.NT;
    const float* p = partial
        + (((long long)nb * g.m_groups + grp) * kRows + row % kRows) * g.NT
        + co % g.NT;
    float s = 0.f;
    for (int k = 0; k < g.k_splits; ++k) s += p[k * stride];
    dw[idx] = s;
}

template <int NT>
cudaError_t launch_main(const float* x, const float* pk, float* partial,
                        const Geom& g, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        reflect_conv_wgrad_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(g.m_groups, g.k_splits, g.n_tiles);
    reflect_conv_wgrad_kernel<NT><<<grid, kThreads, g.smem, stream>>>(
        x, pk, partial, g);
    return cudaGetLastError();
}

bool plan_on(Geom& g, int B, int CI, int CO, int S0, int S1, int S2,
             int device) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
        != cudaSuccess)
        return false;
    return B > 0 && CI > 0 && CO > 0 && S0 >= 2 && S1 >= 2 && S2 >= 2
        && plan(g, B, CI, CO, S0, S1, S2, sms);
}

}  // namespace

// Floats of scratch a launch at this shape needs: sizes[0] for the packed
// dy, sizes[1] for the partial sums. Returns a cudaError_t.
extern "C" int reflect_conv_wgrad_scratch(int B, int CI, int CO, int S0,
                                          int S1, int S2, int device,
                                          long long* sizes) {
    Geom g;
    if (!plan_on(g, B, CI, CO, S0, S1, S2, device))
        return (int)cudaErrorInvalidConfiguration;
    sizes[0] = packed_floats(g);
    sizes[1] = partial_floats(g);
    return 0;
}

// x (B, CI, S0, S1, S2), dy (B, CO, S0, S1, S2), dw (CO, CI, 3, 3, 3), all
// fp32, contiguous, on `device`; pk and partial scratch of the sizes
// reflect_conv_wgrad_scratch gives. Three launches on `stream` (pack,
// GEMM, reduction); returns the first failing one's cudaError_t.
extern "C" int reflect_conv_wgrad_tf32x3(const float* x, const float* dy,
                                         float* pk, float* partial,
                                         float* dw, int B, int CI, int CO,
                                         int S0, int S1, int S2, int device,
                                         void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Geom g;
    if (!plan_on(g, B, CI, CO, S0, S1, S2, device))
        return (int)cudaErrorInvalidConfiguration;
    g.vec = g.vec && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long units = (long long)g.n_stages * g.CO * 2 * g.NG;
    wgrad_pack_kernel<<<(unsigned)((units + 255) / 256), 256, 0, s>>>(
        dy, reinterpret_cast<float4*>(pk), g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    switch (g.NT) {
        case 8: err = launch_main<8>(x, pk, partial, g, s); break;
        case 16: err = launch_main<16>(x, pk, partial, g, s); break;
        case 32: err = launch_main<32>(x, pk, partial, g, s); break;
        case 64: err = launch_main<64>(x, pk, partial, g, s); break;
        case 72: err = launch_main<72>(x, pk, partial, g, s); break;
        default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    const int outs = g.CO * kTaps * g.CI;
    wgrad_reduce_kernel<<<(outs + 255) / 256, 256, 0, s>>>(partial, dw, g);
    return (int)cudaGetLastError();
}
