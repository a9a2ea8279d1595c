// Reflect-pad-1 + k3/s1 3D convolution + bias (+ LeakyReLU) for tiny
// channel counts (ci * co <= 32 in the network; the wrapper takes
// ci * co <= 455), the generators' HR 8 -> 1..3 tail conv.
//
// Replaces: sup3r_tpu/ops/pallas_kernels.py::_small_conv_core (Pallas
// body _small_conv_kernel), reached through small_reflect_conv.
//
// Bound on an H100 SXM: bytes and operations alike. At the flagship
// tail, x (16, 8, 60, 60, 96) -> y (16, 2, 60, 60, 96), it must read
// 176.9 MB and write 44.2 MB (~66 us at 3.35 TB/s) for 4.78 GFLOP
// (~71 us at 67 TFLOP/s fp32 on the CUDA cores), so the kernel has to
// stream its input once and keep the FMA pipe busy at the same time.
//
// Design: a block owns a tile of one batch item, TH (h) x 10 (w) x 32
// (t) outputs (TH = 6 at COT <= 2, 4 at COT = 3, 2 at COT = 4), for
// COT <= 4 output channels (a larger CO runs in groups of 4, one group
// per block). It walks the input channels through a 2-stage ring in
// shared memory, one __syncthreads per channel. Per channel it stages
// the channel's 27 x COT weights (one bulk copy) and the (TH + 2) x 12
// lines of the input window:
// - T % 4 == 0 and 16-byte aligned tensors: one tensor (TMA) copy, a
//   box of TH + 2 rows x 12 lines x 44 t of the input's tensor map,
//   completing on an mbarrier at no cost to the load/store pipe. The
//   box reads zeros outside H, W and T. At the h edges the threads copy
//   the rows h = 1 and H - 2 over the rows h = -1 and H once the stage
//   has landed; the threads next to a w or t edge read the reflected
//   line or cell from inside the window. (One copy per h row, or per
//   line, measured slower: the staging time follows the request count
//   more than the bytes.)
// - otherwise: 4-byte cp.async per cell, reflect by index math.
// Each thread holds a register block of RH (h) x 4 (t) outputs for
// every channel of its group. Per (channel, dw) it reads each of its
// RH + 2 input lines once (one aligned float4 and two edge words) and
// feeds the 6 values to up to 3 output rows x 3 dt taps: at COT = 2,
// 648 FMAs per thread and channel against 45 line loads and 18
// broadcast float4 weight loads, where a one-voxel-per-thread design
// issues one global load per FMA. Blocks of 160 threads, four resident
// per SM at up to 102 registers: 20 warps, which wait at one barrier per
// block five at a time (20 w x 320 threads, ablate's tw20, ran 2.7%
// slower at -> 2 for all its smaller halo). Stores are float4 along t
// on the bulk path, with bias and LeakyReLU in the epilogue. Arithmetic
// is fp32 FMA; the sum runs over ci, then dw, the rows, dh, dt.
//
// What binds it at the flagship tail (python3 -m
// sup3r_tpu_torch.ops.ablate, on an H100 80GB HBM3 at 700 W): the FMAs
// with their weight reads alone take ~0.13 ms of the kernel's ~0.14 ms,
// the staging and stores alone ~0.12 ms; the FMAs would take 0.071 ms
// at the fp32 peak. In their way: the loads, address math, waits and
// barriers that share the issue slots, and 2880 blocks filling 5.45
// waves of 528 resident ones.
//
// Weights arrive packed by the wrapper as (CO groups, CI, 9 (dh, dw),
// G) with G = 3 * COT (dt, co) zero-padded to a multiple of 4.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

constexpr int kTT = 32;                    // t per block
constexpr int kRT = 4;                     // consecutive t per thread
constexpr int kLT = kTT / kRT;             // threads along t
constexpr int kTW = 10;                    // w per block, a thread each
constexpr int kLH = 2;                     // threads along h
constexpr int kThreads = kLT * kTW * kLH;  // 160, five warps
constexpr int kMinBlocks = 4;              // resident blocks per SM
constexpr int kWarps = kThreads / 32;
// a staged line: cell p holds t = t0 - 4 + p (cells 3 .. 36 are read);
// the box's t extent, a multiple of 16 bytes
constexpr int kPitch = 44;
// a staged h row: lines w0 - 1 .. w0 + kTW
constexpr int kRowPitch = (kTW + 2) * kPitch;
constexpr int kStages = 2;

template <int COT>
struct Tile {
    // output rows per thread: the register block is RH * kRT * COT
    static constexpr int RH = COT <= 2 ? 3 : (COT == 3 ? 2 : 1);
    static constexpr int TH = kLH * RH;
    static constexpr int kLines = (TH + 2) * (kTW + 2);
    static constexpr int G = (3 * COT + 3) / 4 * 4;  // floats per (dh, dw)
    static constexpr int kWFloats = 9 * G;
    static constexpr int kWPad = (kWFloats + 31) / 32 * 32;
    // a stage, on a 128-byte boundary
    static constexpr int kStageFloats =
        (kWPad + (TH + 2) * kRowPitch + 31) / 32 * 32;
    static constexpr size_t kSmem = sizeof(float) * kStages * kStageFloats
        + sizeof(uint64_t) * kStages;
};

template <int COT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
small_reflect_conv_kernel(const __grid_constant__ CUtensorMap window,
                          const float* __restrict__ x,
                          const float* __restrict__ wp,
                          const float* __restrict__ bias,
                          float* __restrict__ y, int CI, int CO, int H,
                          int W, int T, int n_groups, int n_tt, int n_tw,
                          int n_th, int bulk, int has_alpha, float alpha) {
    using Tl = Tile<COT>;
    constexpr int RH = Tl::RH, G = Tl::G;
    extern __shared__ __align__(128) float smem[];
    uint64_t* full =
        reinterpret_cast<uint64_t*>(smem + kStages * Tl::kStageFloats);

    int idx = blockIdx.x;
    const int g = idx % n_groups;
    idx /= n_groups;
    const int t0 = (idx % n_tt) * kTT;
    idx /= n_tt;
    const int w0 = (idx % n_tw) * kTW;
    idx /= n_tw;
    const int h0 = (idx % n_th) * Tl::TH;
    const int b = idx / n_th;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) {
        for (int s = 0; s < kStages; ++s)
            mbar_init(&full[s], bulk ? kThreads : 2 * kThreads);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // window line r, at r * kPitch of a stage's lines, holds input
    // (h0 - 1 + r / (kTW + 2), w0 - 1 + r % (kTW + 2)), reflected at the
    // edges
    auto line_at = [&](int r) {
        return ((long long)reflect1(h0 - 1 + r / (kTW + 2), H) * W
                + reflect1(w0 - 1 + r % (kTW + 2), W)) * T;
    };
    // the cp.async path: lane l fills cell 3 + l (t0 - 1 + l), lanes 0, 1
    // also cells 35, 36
    const int ta = reflect1(t0 - 1 + lane, T);
    const int tb = reflect1(t0 + kTT - 1 + lane, T);
    const long long plane = (long long)H * W * T;
    const float* xb = x + (long long)b * CI * plane;
    const float* wg = wp + (long long)g * CI * Tl::kWFloats;
    auto stage = [&](int ci) {
        float* s = smem + (ci % kStages) * Tl::kStageFloats;
        uint64_t* bar = &full[ci % kStages];
        const float* xc = xb + ci * plane;
        float* lines = s + Tl::kWPad;
        // the stage was last read (and at the h edges written) through
        // the generic proxy; order that before the async proxy's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        int bytes = 0;
        if (bulk) {
            // one box of the tensor map: rows h0 - 1 .. h0 + TH, lines
            // w0 - 1 .. w0 + kTW, t0 - 4 .. t0 + 39; zeros out of range
            if (tid == 0) {
                tensor_copy_4d(lines, &window, t0 - 4, w0 - 1, h0 - 1,
                               b * CI + ci, bar);
                bytes = 4 * Tl::kLines * kPitch;
            }
        } else {
            for (int r = warp; r < Tl::kLines; r += kWarps) {
                const float* src = xc + line_at(r);
                float* dst = lines + r * kPitch + 3;
                cp_async4(dst + lane, src + ta);
                if (lane < 2) cp_async4(dst + kTT + lane, src + tb);
            }
            cp_async_arrive(bar);
        }
        if (tid == kThreads - 1) {
            bulk_copy(s, wg + (long long)ci * Tl::kWFloats,
                      4 * Tl::kWFloats, bar);
            bytes += 4 * Tl::kWFloats;
        }
        mbar_expect_tx(bar, bytes);
    };

    const int lt = tid % kLT, lw = (tid / kLT) % kTW, lh = tid / (kLT * kTW);
    const int mine = lh * RH * kRowPitch + lt * kRT;
    // the thread's lines for dw = 0, 1, 2: w = -1 and w = W are w = 1
    // and W - 2, the w reflect, which the bulk path's box leaves out
    int col[3];
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) {
        const int w = w0 + lw + dw - 1;
        col[dw] = (lw + dw + (w < 0 ? 2 : w == W ? -2 : 0)) * kPitch;
    }
    // cells of the thread's t - 1 and t + kRT, or of t = 1 for t = -1 and
    // t = T - 2 for t = T: the t reflect, which the bulk path leaves out
    // of the staged lines (T % kRT == 0 puts it on these two)
    const int e0 = t0 + lt * kRT == 0 ? 5 : 3;
    const int e1 = t0 + lt * kRT + kRT == T ? kRT + 2 : kRT + 4;
    // the window row of h = H, and whether the window holds h = -1 or H
    const int h_end = H - h0 + 1;
    const bool reflect_h = h0 == 0 || h_end <= Tl::TH + 1;
    float acc[RH][kRT][COT];
#pragma unroll
    for (int o = 0; o < RH; ++o)
#pragma unroll
        for (int j = 0; j < kRT; ++j)
#pragma unroll
            for (int c = 0; c < COT; ++c) acc[o][j][c] = 0.f;

    for (int ci = 0; ci < kStages - 1 && ci < CI; ++ci) stage(ci);
    for (int ci = 0; ci < CI; ++ci) {
        float* s = smem + (ci % kStages) * Tl::kStageFloats;
        mbar_wait(&full[ci % kStages], (ci / kStages) & 1);
        if (bulk && reflect_h) {
            // the h reflect the box leaves out: rows h = -1 and h = H are
            // copies of h = 1 and h = H - 2
            float* rows = s + Tl::kWPad;
            for (int i = tid; i < kRowPitch; i += kThreads) {
                if (h0 == 0) rows[i] = rows[2 * kRowPitch + i];
                if (h_end <= Tl::TH + 1)
                    rows[h_end * kRowPitch + i] =
                        rows[(h_end - 2) * kRowPitch + i];
            }
        }
        // the stage is complete, and every thread is done with ci - 1,
        // whose stage the copies issued next refill
        __syncthreads();
        if (ci + kStages - 1 < CI) stage(ci + kStages - 1);
        const float* lines = s + Tl::kWPad + mine;
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
            // the (dh, dw) weights of this dw
            float wv[3][G];
#pragma unroll
            for (int dh = 0; dh < 3; ++dh)
#pragma unroll
                for (int q = 0; q < G / 4; ++q) {
                    const float4 f = *reinterpret_cast<const float4*>(
                        s + (dh * 3 + dw) * G + 4 * q);
                    wv[dh][4 * q] = f.x;
                    wv[dh][4 * q + 1] = f.y;
                    wv[dh][4 * q + 2] = f.z;
                    wv[dh][4 * q + 3] = f.w;
                }
#pragma unroll
            for (int r = 0; r < RH + 2; ++r) {
                const float* p = lines + r * kRowPitch + col[dw];
                // v[i] is t = t0 + lt * kRT - 1 + i, cell lt * kRT + 3 + i
                float v[kRT + 2];
                v[0] = p[e0];
#pragma unroll
                for (int q = 0; q < kRT / 4; ++q) {
                    const float4 f =
                        *reinterpret_cast<const float4*>(p + 4 + 4 * q);
                    v[4 * q + 1] = f.x;
                    v[4 * q + 2] = f.y;
                    v[4 * q + 3] = f.z;
                    v[4 * q + 4] = f.w;
                }
                v[kRT + 1] = p[e1];
#pragma unroll
                for (int dh = 0; dh < 3; ++dh) {
                    const int o = r - dh;
                    if (o < 0 || o >= RH) continue;
#pragma unroll
                    for (int dt = 0; dt < 3; ++dt)
#pragma unroll
                        for (int j = 0; j < kRT; ++j)
#pragma unroll
                            for (int c = 0; c < COT; ++c)
                                acc[o][j][c] = fmaf(v[j + dt],
                                                    wv[dh][dt * COT + c],
                                                    acc[o][j][c]);
                }
            }
        }
    }

    const int w = w0 + lw, t = t0 + lt * kRT;
    if (w >= W || t >= T) return;
    const bool vec = bulk && t + kRT <= T;  // aligned float4 stores
#pragma unroll
    for (int c = 0; c < COT; ++c) {
        const int co = g * COT + c;
        if (co >= CO) break;
        const float bc = bias[co];
#pragma unroll
        for (int o = 0; o < RH; ++o) {
            const int h = h0 + lh * RH + o;
            if (h >= H) break;
            float out[kRT];
#pragma unroll
            for (int j = 0; j < kRT; ++j)
                out[j] = leaky(acc[o][j][c] + bc, has_alpha, alpha);
            float* dst = y + (((long long)b * CO + co) * H + h) * W * T
                + (long long)w * T + t;
            if (vec) {
#pragma unroll
                for (int q = 0; q < kRT / 4; ++q)
                    *reinterpret_cast<float4*>(dst + 4 * q) = make_float4(
                        out[4 * q], out[4 * q + 1], out[4 * q + 2],
                        out[4 * q + 3]);
            } else {
#pragma unroll
                for (int j = 0; j < kRT; ++j)
                    if (t + j < T) dst[j] = out[j];
            }
        }
    }
}

// The tensor map of x viewed as (B * CI, H, W, T), in boxes of `rows` h
// rows of kTW + 2 lines of kPitch t: what the bulk path's copies read.
int encode_window(CUtensorMap* map, const float* x, int B, int CI, int H,
                  int W, int T, int rows) {
    static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return (int)err;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr)
            return (int)cudaErrorSymbolNotFound;
        encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    }
    const cuuint64_t dims[4] = {(cuuint64_t)T, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B * CI};
    const cuuint64_t strides[3] = {(cuuint64_t)T * 4, (cuuint64_t)W * T * 4,
                                   (cuuint64_t)H * W * T * 4};
    const cuuint32_t box[4] = {kPitch, kTW + 2, (cuuint32_t)rows, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    const CUresult res = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), dims,
        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int COT>
int launch(const float* x, const float* wp, const float* bias, float* y,
           int B, int CI, int H, int W, int T, int CO, int has_alpha,
           float alpha, cudaStream_t s) {
    using Tl = Tile<COT>;
    cudaError_t err = cudaFuncSetAttribute(
        small_reflect_conv_kernel<COT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
    if (err != cudaSuccess) return (int)err;
    const int n_groups = (CO + COT - 1) / COT;
    const int n_tt = (T + kTT - 1) / kTT;
    const int n_tw = (W + kTW - 1) / kTW;
    const int n_th = (H + Tl::TH - 1) / Tl::TH;
    const long long blocks = (long long)B * n_th * n_tw * n_tt * n_groups;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    // bulk copies and float4 stores need 16-byte aligned lines
    const int bulk = T % 4 == 0 && T % kRT == 0
        && ((uintptr_t)x | (uintptr_t)wp | (uintptr_t)y) % 16 == 0;
    CUtensorMap window = {};
    if (bulk) {
        const int res = encode_window(&window, x, B, CI, H, W, T, Tl::TH + 2);
        if (res) return res;
    }
    small_reflect_conv_kernel<COT><<<(unsigned)blocks, kThreads, Tl::kSmem,
                                     s>>>(
        window, x, wp, bias, y, CI, CO, H, W, T, n_groups, n_tt, n_tw, n_th,
        bulk, has_alpha, alpha);
    return (int)cudaGetLastError();
}

}  // namespace

// x (B, CI, H, W, T), wp packed (ceil(CO / COT), CI, 9, G) with
// COT = min(CO, 4), bias (CO,), y (B, CO, H, W, T); all fp32,
// contiguous, on `device`. Returns the cudaError_t of the launch.
extern "C" int small_reflect_conv_f32(const float* x, const float* wp,
                                      const float* bias, float* y, int B,
                                      int CI, int H, int W, int T, int CO,
                                      int has_alpha, float alpha, int device,
                                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (CO < 1 || CI < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (CO) {
        case 1:
            return launch<1>(x, wp, bias, y, B, CI, H, W, T, CO, has_alpha,
                             alpha, s);
        case 2:
            return launch<2>(x, wp, bias, y, B, CI, H, W, T, CO, has_alpha,
                             alpha, s);
        case 3:
            return launch<3>(x, wp, bias, y, B, CI, H, W, T, CO, has_alpha,
                             alpha, s);
        default:
            return launch<4>(x, wp, bias, y, B, CI, H, W, T, CO, has_alpha,
                             alpha, s);
    }
}
