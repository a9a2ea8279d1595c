// Reflect-pad-1 + k3/s1 convolution + bias (+ LeakyReLU), 2D or 3D, fp32
// in and out, as an implicit GEMM on the tensor cores in 3xTF32: the
// fused generator block for inference.
//
// Replaces: sup3r_tpu/ops/pallas_kernels.py::reflect_conv (Pallas bodies
// _reflect_conv_kernel_3d / _reflect_conv_kernel_2d, whose 27 taps were
// MXU matmuls, and the halo builder _reflect_pad_scratch).
//
// Bound on an H100 SXM: operations. One flagship body conv, x (16, 64,
// 20, 20, 96) -> 64 channels, is 135.9 GFLOP against 315 MB of traffic
// (~94 us at 3.35 TB/s). On the CUDA cores in fp32 that is 2.028 ms at
// 67 TFLOP/s; as three TF32 products on the tensor cores it is 0.824 ms
// at 495 TFLOP/s. The tensor-core bound is the lesser and binds.
//
// Numerics: each operand v splits into hi = tf32(v), rounded to nearest
// with ties away (cvt.rna.tf32.f32 semantics), and lo = v - hi, of which
// the tensor cores read the TF32 part; every K-step issues lo*hi, hi*lo
// and hi*hi (the wrapper rounds the weights' lo to TF32 itself). The
// dropped lo*lo term is ~2^-22 relative. The tensor cores
// add into their accumulator with truncation, which over 27 * CI / 8 * 3
// steps would cost ~1e-5 of the output; so each stage's products go to a
// fresh accumulator that is added to an fp32 sum (round to nearest).
// Outputs keep fp32-class accuracy, not bit equality with cuDNN.
//
// Design. GEMM view: M = output cells, N = output channels, K = taps x
// input channels; neither an im2col tensor nor the padded input is ever
// written to device memory.
// - M: the S1 x TT cells of one (batch item, plane s0, t tile) "strip",
//   line after line; a block takes 2 * MT * 64 consecutive rows of a
//   strip (MT = 2, or 1 when NT = 128) and one N tile NT of the output
//   channels (NT = CO rounded up to 32, 64 or 72, so the 64 -> 72 conv is
//   one tile, else tiles of 128).
// - A producer warpgroup fills a ring of kRing stages in shared memory. A
//   stage is 8 input channels x one input plane (tap k0) of the block's
//   lines plus a reflect halo line on each side, channels-first as in
//   device memory (one line per thread, 16-byte cp.async along t, the
//   reflect halo by index math), and that (chunk, k0)'s 9 taps of hi/lo
//   weights in wgmma's K-major, unswizzled core-matrix layout (one bulk
//   TMA copy). Both complete on the stage's "full" mbarrier; consumers
//   release it on its "empty" mbarrier.
// - Two consumer warpgroups each own MT tiles of 64 rows. Per tap they
//   load their A fragments straight from the staged tile (a tap is a
//   constant offset into it), split them to hi/lo in registers, and issue
//   3 x MT wgmma.m64nNTk8 (A from registers, B from shared memory); A
//   fragments alternate between two register sets, so one tap's loads
//   overlap the previous tap's wgmmas.
// - Epilogue: bias and LeakyReLU in registers, channels-first stores in
//   runs of 8 cells along t.
// The weights are split and laid out once per launch by the wrapper
// (sup3r_tpu_torch/ops/kernels.py::pack_weights).

#include <cstdint>

#include "common.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kKC = 8;                      // input channels per K-step
constexpr int kTaps = 9;                    // (k1, k2) taps per stage
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kProducers = 128;             // and one producer warpgroup
constexpr int kThreads = kConsumers + kProducers;
// Registers a thread of each role keeps after setmaxnreg; the block is
// launched at 168 (65536 / 384) and the producers hand theirs over.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRing = 2;                    // stages in shared memory
constexpr int kSmemMax = 232448;            // 227 KB a block may use
constexpr int kBarBytes = 128;              // mbarriers, ahead of the ring
constexpr int kOff = 4;                     // staged column of t0 (16 B)

// Per-launch geometry, the same for every block.
struct Geom {
    int CI, CO, S0, S1, S2, K0;
    int TT;           // t tile: cells along s2
    int LS, CS;       // staged line and channel strides (floats)
    int nt2, nm;      // t tiles, row blocks per (b, s0, t tile) strip
    int n_stages;     // ceil(CI / 8) * K0
    int vec;          // 16-byte copies along t
    int has_alpha;
    float alpha;
};

// TF32 of a float's bits, rounded to nearest with ties away from zero:
// bit for bit what cvt.rna.tf32.f32 gives for finite input, on the
// integer pipes (the conversion unit has a quarter of their throughput).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// K-major, unswizzled B tile: core matrices of 8 rows x 16 bytes, the
// two k-halves `lbo` bytes apart, successive 8-row groups 128 bytes apart.
__device__ __forceinline__ uint64_t desc_b(const float* p, int lbo) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
        | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int NT>
__host__ __device__ constexpr int weight_floats() {
    return kTaps * 2 * kKC * NT;
}

// The producer warpgroup: fills stage after stage of the ring. Thread 0
// sends the stage's weight slice as one bulk copy; the threads copy the
// halo tile with cp.async, one (channel, line) each, which keeps the
// instructions per copy few.
template <int NT>
__device__ __forceinline__ void produce(const float* __restrict__ x,
                                        const float* __restrict__ w,
                                        float* ring, uint64_t* full,
                                        uint64_t* empty, const Geom g, int b,
                                        int s0, int l_first, int n_lines,
                                        int t0, int nb) {
    constexpr int kWBytes = 4 * weight_floats<NT>();
    const int pt = threadIdx.x - kConsumers;
    const int act_floats = kKC * g.CS;
    const int stage_floats = act_floats + weight_floats<NT>();
    const int n_chunks = (g.CI + kKC - 1) / kKC;
    const long long plane = (long long)g.S1 * g.S2;
    for (int st = 0; st < g.n_stages; ++st) {
        const int s = st % kRing;
        if (st >= kRing) mbar_wait(&empty[s], (st / kRing - 1) & 1);
        const int c = st / g.K0;
        const int k0 = st % g.K0;
        float* act = ring + s * stage_floats;
        if (pt == 0) {
            mbar_expect_tx(&full[s], kWBytes);
            bulk_copy(act + act_floats,
                      w + ((long long)(nb * n_chunks + c) * g.K0 + k0)
                          * weight_floats<NT>(),
                      kWBytes, &full[s]);
        }
        const float* src_plane = x + (long long)b * g.CI * g.S0 * plane
            + (long long)(g.K0 == 3 ? reflect1(s0 + k0 - 1, g.S0) : 0) * plane;
        for (int p = pt; p < kKC * n_lines; p += kProducers) {
            const int ch = p / n_lines;
            const int l = p - ch * n_lines;
            // Channels past CI copy channel CI - 1: their weights are zero.
            const float* src = src_plane
                + (long long)min(c * kKC + ch, g.CI - 1) * g.S0 * plane
                + (long long)reflect1(l_first - 1 + l, g.S1) * g.S2;
            // column q of the staged line holds t0 - 1 + q
            float* dst = act + ch * g.CS + l * g.LS + kOff - 1;
            if (g.vec) {
                for (int j = 0; j < g.TT; j += 4)
                    cp_async16(dst + 1 + j, src + t0 + j);
                cp_async4(dst, src + reflect1(t0 - 1, g.S2));
                cp_async4(dst + g.TT + 1, src + reflect1(t0 + g.TT, g.S2));
            } else {
                for (int q = 0; q < g.TT + 2; ++q)
                    cp_async4(dst + q, src + reflect1(t0 - 1 + q, g.S2));
            }
        }
        cp_async_arrive(&full[s]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The two consumer warpgroups: the GEMM over every stage, then the
// epilogue.
template <int NT, int MT>
__device__ __forceinline__ void consume(const float* ring, uint64_t* full,
                                        uint64_t* empty,
                                        const float* __restrict__ bias,
                                        float* __restrict__ y, const Geom g,
                                        int b, int s0, int m0, int l_first,
                                        int t0, int nb) {
    const int rows = g.S1 * g.TT;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int gr = lane >> 2;
    const int tq = lane & 3;
    const int act_floats = kKC * g.CS;
    const int stage_floats = act_floats + weight_floats<NT>();

    // Each thread's A rows: (warpgroup tile, 16-row warp slice, lane / 4,
    // + 8). Rows past the strip read line 0 and are never stored.
    int row_off[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = m0 + ((warp >> 2) * MT + mt) * 64 + (warp & 3) * 16
                + gr + 8 * h;
            row_off[mt][h] = (r < rows
                ? (r / g.TT - l_first) * g.LS + r % g.TT : 0) + kOff - 1;
        }

    // The tensor cores add into their accumulator with truncation, so a
    // stage's products go to `acc` and each stage's sum is added to `sum`
    // in fp32 with round-to-nearest.
    float sum[MT][NT / 2], acc[MT][NT / 2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) sum[mt][i] = acc[mt][i] = 0.f;

    for (int st = 0; st < g.n_stages; ++st) {
        const int s = st % kRing;
        mbar_wait(&full[s], (st / kRing) & 1);
        const float* act = ring + s * stage_floats + tq * g.CS;
        const float* wsm = ring + s * stage_floats + act_floats;
        // A fragments alternate between two register sets, so a tap's
        // loads and splits overlap the previous tap's wgmmas.
        uint32_t ah[2][MT][4], al[2][MT][4];
#pragma unroll
        for (int tap = 0; tap < kTaps; ++tap) {
            const int off = (tap / 3) * g.LS + tap % 3;
            uint32_t (&h)[MT][4] = ah[tap & 1];
            uint32_t (&l)[MT][4] = al[tap & 1];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                // a0 (row, k), a1 (row + 8, k), a2 (row, k + 4),
                // a3 (row + 8, k + 4), k = lane % 4
                const float v[4] = {
                    act[row_off[mt][0] + off], act[row_off[mt][1] + off],
                    act[4 * g.CS + row_off[mt][0] + off],
                    act[4 * g.CS + row_off[mt][1] + off]};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    // lo goes in as fp32 bits: the tensor cores read
                    // only its TF32 part
                    h[mt][e] = tf32_rna(v[e]);
                    l[mt][e] = __float_as_uint(v[e]
                                               - __uint_as_float(h[mt][e]));
                }
            }
            const float* wt = wsm + tap * 2 * kKC * NT;
            const uint64_t bh = desc_b(wt, 16 * NT);
            const uint64_t bl = desc_b(wt + kKC * NT, 16 * NT);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                Wgmma<NT>::run(acc[mt], l[mt], bh, tap > 0);
                Wgmma<NT>::run(acc[mt], h[mt], bl, 1);
                Wgmma<NT>::run(acc[mt], h[mt], bh, 1);
            }
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            // the previous tap's group is done: its registers are free
            asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
        mbar_arrive(&empty[s]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < NT / 2; ++i) sum[mt][i] += acc[mt][i];
    }

    const long long plane = (long long)g.S0 * g.S1 * g.S2;
    const long long out0 = (long long)b * g.CO * plane
        + (long long)s0 * g.S1 * g.S2 + t0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = m0 + ((warp >> 2) * MT + mt) * 64 + (warp & 3) * 16
                + gr + 8 * h;
            const int tt = r % g.TT;
            if (r >= rows || t0 + tt >= g.S2) continue;
            float* yr = y + out0 + (long long)(r / g.TT) * g.S2 + tt;
#pragma unroll
            for (int j = 0; j < NT / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = nb * NT + 8 * j + 2 * tq + e;
                    if (n < g.CO)
                        yr[n * plane] = leaky(sum[mt][4 * j + 2 * h + e]
                                              + bias[n], g.has_alpha,
                                              g.alpha);
                }
        }
}

// x (B, CI, S0, S1, S2); w packed by the wrapper as (CO tiles, CI chunks,
// K0, 9 taps, hi/lo, 2 k-halves, NT, 4); bias (CO,); y (B, CO, S0, S1,
// S2). For 2D inputs S0 == 1 and K0 == 1.
template <int NT, int MT>
__global__ void __launch_bounds__(kThreads, 1)
reflect_conv_tc_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       float* __restrict__ y, const Geom g) {
    constexpr int kRows = 2 * MT * 64;
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + kRing;
    float* ring = reinterpret_cast<float*>(smem + kBarBytes);

    // Block -> (row block of a strip, t tile, plane s0); a strip is the
    // S1 lines x TT cells of one (b, s0, t tile), flattened line by line.
    int tile = blockIdx.x;
    const int m0 = (tile % g.nm) * kRows;
    tile /= g.nm;
    const int t0 = (tile % g.nt2) * g.TT;
    const int s0 = tile / g.nt2;
    const int nb = blockIdx.y;
    const int b = blockIdx.z;
    const int rows = g.S1 * g.TT;
    const int l_first = m0 / g.TT;
    const int n_lines = (min(m0 + kRows, rows) - 1) / g.TT - l_first + 3;

    if (threadIdx.x == 0) {
        for (int s = 0; s < kRing; ++s) {
            // each producer's cp.async, and the bulk copy's expected bytes
            mbar_init(&full[s], kProducers + 1);
            mbar_init(&empty[s], kConsumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // The roles never meet again, so each keeps its own register count;
    // the warpgroup index goes through a shuffle so that the compiler
    // sees it is uniform across each warp.
    const int warpgroup = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (warpgroup == kConsumers / 128) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                     :: "n"(kProducerRegs));
        produce<NT>(x, w, ring, full, empty, g, b, s0, l_first, n_lines, t0,
                    nb);
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                     :: "n"(kConsumerRegs));
        consume<NT, MT>(ring, full, empty, bias, y, g, b, s0, m0, l_first, t0,
                        nb);
    }
}

int round4(int v) { return (v + 3) & ~3; }

template <int NT, int MT>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* y, int n_spatial, int B, int CI, int CO, int S0,
                   int S1, int S2, int has_alpha, float alpha,
                   cudaStream_t stream) {
    constexpr int kRows = 2 * MT * 64;
    Geom g;
    g.CI = CI; g.CO = CO; g.S0 = S0; g.S1 = S1; g.S2 = S2;
    g.K0 = n_spatial == 3 ? 3 : 1;
    g.has_alpha = has_alpha; g.alpha = alpha;
    // Tile the contiguous axis in near-equal pieces of at most kRows.
    const int n2 = (S2 + kRows - 1) / kRows;
    g.TT = S2 <= kRows ? S2 : round4((S2 + n2 - 1) / n2);
    g.nt2 = (S2 + g.TT - 1) / g.TT;
    g.nm = (S1 * g.TT + kRows - 1) / kRows;
    g.LS = round4(g.TT + kOff + 1);
    // A block's rows touch at most ceil(kRows / TT) + 1 lines; it stages
    // those and a halo line on each side. Channel stride = 8 or 24
    // (mod 32) words: the four k columns of an A fragment fall in
    // distinct banks.
    g.CS = round4(((kRows + g.TT - 1) / g.TT + 3) * g.LS);
    while (g.CS % 32 != 8 && g.CS % 32 != 24) g.CS += 4;
    g.n_stages = (CI + kKC - 1) / kKC * g.K0;
    const int stage_bytes = 4 * (kKC * g.CS + weight_floats<NT>());
    const int smem = kBarBytes + kRing * stage_bytes;
    if (smem > kSmemMax) return cudaErrorInvalidConfiguration;
    g.vec = S2 % 4 == 0 && g.TT % 4 == 0 && S2 % g.TT == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    cudaError_t err = cudaFuncSetAttribute(
        reflect_conv_tc_kernel<NT, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)(g.nm * g.nt2 * S0), (CO + NT - 1) / NT, B);
    reflect_conv_tc_kernel<NT, MT><<<grid, kThreads, smem, stream>>>(
        x, w, bias, y, g);
    return cudaGetLastError();
}

}  // namespace

// n_spatial 3: x (B, CI, S0, S1, S2); n_spatial 2: x (B, CI, S1, S2) with
// S0 == 1. w packed for N tile `n_tile` (32, 64, 72 or 128) by
// sup3r_tpu_torch/ops/kernels.py::pack_weights; bias (CO,); y like x with
// CO channels; all fp32, contiguous, on `device`. Returns the cudaError_t
// of the launch.
extern "C" int reflect_conv_tf32x3(const float* x, const float* w,
                                   const float* bias, float* y,
                                   int n_spatial, int B, int CI, int CO,
                                   int S0, int S1, int S2, int n_tile,
                                   int has_alpha, float alpha, int device,
                                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (!(n_spatial == 3 || (n_spatial == 2 && S0 == 1)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (n_tile) {
        case 32:
            return (int)launch<32, 2>(x, w, bias, y, n_spatial, B, CI, CO,
                                      S0, S1, S2, has_alpha, alpha, s);
        case 64:
            return (int)launch<64, 2>(x, w, bias, y, n_spatial, B, CI, CO,
                                      S0, S1, S2, has_alpha, alpha, s);
        case 72:
            return (int)launch<72, 2>(x, w, bias, y, n_spatial, B, CI, CO,
                                      S0, S1, S2, has_alpha, alpha, s);
        case 128:
            return (int)launch<128, 1>(x, w, bias, y, n_spatial, B, CI, CO,
                                       S0, S1, S2, has_alpha, alpha, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
