// Reflect-pad-1 + k3/s1 convolution + bias (+ LeakyReLU), 2D or 3D,
// fp32 in and out with fp32 FMA accumulation (no TF32): the fused
// generator block for inference.
//
// Replaces: sup3r_tpu/ops/pallas_kernels.py::reflect_conv (Pallas
// bodies _reflect_conv_kernel_3d / _reflect_conv_kernel_2d and the halo
// builder _reflect_pad_scratch).
//
// Bound on an H100 SXM: operations. One flagship body conv, x (16, 64,
// 20, 20, 96) -> (16, 64, 20, 20, 96), is 135.9 GFLOP (~2.0 ms at 67
// TFLOP/s fp32 on the CUDA cores) against 315 MB of traffic (~94 us).
//
// Design: a simple tiled direct convolution on CUDA cores. A block owns
// one batch item, an output tile of T0 x T1 x 32 cells (the last,
// contiguous axis across the 32 lanes of a warp) and 64 output channels
// (8 per warp). For each slice of CIC input channels it stages the input
// tile plus its 1-cell reflect halo in shared memory, with the reflect
// done by index math on the load (the padded tensor is never
// materialised), and the matching (CIC, taps, 64) weight slice. Each
// thread then keeps 8 cells x 8 channels of fp32 accumulators in
// registers: every tap costs it 8 conflict-free shared loads of x, two
// broadcast float4 loads of weights and 64 FMAs. Bias and LeakyReLU are
// applied in the epilogue. The 2D case is the 3D one with a unit leading
// axis and no taps along it. Tensor cores (wgmma, with TMA staging) are
// left to a later redesign: exact mode is fp32.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kT2 = 32;        // tile along the contiguous axis (lanes)
constexpr int kCOT = 64;       // output channels per block
constexpr int kCPW = 8;        // output channels per warp
constexpr int kCIC = 4;        // input channels staged per step

template <int NS>
struct Tile {
    static constexpr int K0 = NS == 3 ? 3 : 1;   // taps on the leading axis
    static constexpr int TAPS = K0 * 9;
    static constexpr int T0 = NS == 3 ? 2 : 1;   // output tile, axis 0
    static constexpr int T1 = NS == 3 ? 4 : 8;   // output tile, axis 1
    static constexpr int P = T0 * T1;            // cells per thread
    static constexpr int X0 = T0 + K0 - 1;       // staged tile with halo
    static constexpr int X1 = T1 + 2;
    static constexpr int X2 = kT2 + 2;
    static constexpr int XS = kCIC * X0 * X1 * X2;
    static constexpr int WS = kCIC * TAPS * kCOT;
};

// x (B, CI, S0, S1, S2), w (CI, TAPS, CO), bias (CO,), y (B, CO, S0, S1,
// S2). For NS == 2, S0 == 1 and the leading axis is not reflected.
template <int NS>
__global__ void __launch_bounds__(kThreads, 2)
reflect_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ y,
                    int CI, int CO, int S0, int S1, int S2, int has_alpha,
                    float alpha) {
    using L = Tile<NS>;
    __shared__ __align__(16) float xs[L::XS];
    __shared__ __align__(16) float ws[L::WS];

    const int n2 = (S2 + kT2 - 1) / kT2;
    const int n1 = (S1 + L::T1 - 1) / L::T1;
    const int tile = blockIdx.x;
    const int o2 = (tile % n2) * kT2;
    const int o1 = ((tile / n2) % n1) * L::T1;
    const int o0 = (tile / (n2 * n1)) * L::T0;
    const int co0 = blockIdx.y * kCOT;
    const int b = blockIdx.z;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    float acc[L::P][kCPW];
#pragma unroll
    for (int p = 0; p < L::P; ++p)
#pragma unroll
        for (int j = 0; j < kCPW; ++j) acc[p][j] = 0.f;

    const long long plane = (long long)S0 * S1 * S2;
    for (int c0 = 0; c0 < CI; c0 += kCIC) {
        __syncthreads();  // the previous slice is no longer read
        for (int i = threadIdx.x; i < L::XS; i += kThreads) {
            const int i2 = i % L::X2;
            int r = i / L::X2;
            const int i1 = r % L::X1;
            r /= L::X1;
            const int i0 = r % L::X0;
            const int ci = c0 + r / L::X0;
            float v = 0.f;
            if (ci < CI) {
                const int s0 = NS == 3 ? reflect1(o0 + i0 - 1, S0) : 0;
                const int s1 = reflect1(o1 + i1 - 1, S1);
                const int s2 = reflect1(o2 + i2 - 1, S2);
                v = __ldg(x + ((long long)b * CI + ci) * plane
                          + ((long long)s0 * S1 + s1) * S2 + s2);
            }
            xs[i] = v;
        }
        for (int i = threadIdx.x; i < L::WS; i += kThreads) {
            const int co = i % kCOT;
            const int r = i / kCOT;  // c * TAPS + tap
            const int ci = c0 + r / L::TAPS;
            const int cg = co0 + co;
            ws[i] = (ci < CI && cg < CO)
                ? __ldg(w + ((long long)ci * L::TAPS + r % L::TAPS) * CO + cg)
                : 0.f;
        }
        __syncthreads();

        for (int c = 0; c < kCIC; ++c) {
#pragma unroll
            for (int k0 = 0; k0 < L::K0; ++k0) {
#pragma unroll
                for (int k1 = 0; k1 < 3; ++k1) {
#pragma unroll
                    for (int k2 = 0; k2 < 3; ++k2) {
                        const int tap = (k0 * 3 + k1) * 3 + k2;
                        const float4* wp = reinterpret_cast<const float4*>(
                            ws + (c * L::TAPS + tap) * kCOT + warp * kCPW);
                        const float4 wa = wp[0];
                        const float4 wb = wp[1];
                        const float wv[kCPW] = {wa.x, wa.y, wa.z, wa.w,
                                                wb.x, wb.y, wb.z, wb.w};
#pragma unroll
                        for (int p0 = 0; p0 < L::T0; ++p0) {
#pragma unroll
                            for (int p1 = 0; p1 < L::T1; ++p1) {
                                const float xv = xs[((c * L::X0 + p0 + k0)
                                                     * L::X1 + p1 + k1)
                                                    * L::X2 + lane + k2];
                                float* a = acc[p0 * L::T1 + p1];
#pragma unroll
                                for (int j = 0; j < kCPW; ++j)
                                    a[j] = fmaf(xv, wv[j], a[j]);
                            }
                        }
                    }
                }
            }
        }
    }

    const int s2 = o2 + lane;
    if (s2 >= S2) return;
#pragma unroll
    for (int p0 = 0; p0 < L::T0; ++p0) {
        const int s0 = o0 + p0;
#pragma unroll
        for (int p1 = 0; p1 < L::T1; ++p1) {
            const int s1 = o1 + p1;
            if (s0 >= S0 || s1 >= S1) continue;
            const long long cell = ((long long)s0 * S1 + s1) * S2 + s2;
#pragma unroll
            for (int j = 0; j < kCPW; ++j) {
                const int cg = co0 + warp * kCPW + j;
                if (cg < CO)
                    y[((long long)b * CO + cg) * plane + cell] = leaky(
                        acc[p0 * L::T1 + p1][j] + bias[cg], has_alpha, alpha);
            }
        }
    }
}

template <int NS>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* y, int B, int CI, int CO, int S0, int S1, int S2,
                   int has_alpha, float alpha, cudaStream_t stream) {
    using L = Tile<NS>;
    const unsigned tiles = (unsigned)((S0 + L::T0 - 1) / L::T0)
        * ((S1 + L::T1 - 1) / L::T1) * ((S2 + kT2 - 1) / kT2);
    const dim3 grid(tiles, (CO + kCOT - 1) / kCOT, B);
    reflect_conv_kernel<NS><<<grid, kThreads, 0, stream>>>(
        x, w, bias, y, CI, CO, S0, S1, S2, has_alpha, alpha);
    return cudaGetLastError();
}

}  // namespace

// n_spatial 3: x (B, CI, S0, S1, S2), w (CI, 3, 3, 3, CO).
// n_spatial 2: x (B, CI, S1, S2) with S0 == 1, w (CI, 3, 3, CO).
// bias (CO,), y like x with CO channels; all fp32, contiguous, on
// `device`. Returns the cudaError_t of the launch.
extern "C" int reflect_conv_f32(const float* x, const float* w,
                                const float* bias, float* y, int n_spatial,
                                int B, int CI, int CO, int S0, int S1, int S2,
                                int has_alpha, float alpha, int device,
                                void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_spatial == 3)
        return (int)launch<3>(x, w, bias, y, B, CI, CO, S0, S1, S2,
                              has_alpha, alpha, s);
    if (n_spatial == 2 && S0 == 1)
        return (int)launch<2>(x, w, bias, y, B, CI, CO, S0, S1, S2,
                              has_alpha, alpha, s);
    return (int)cudaErrorInvalidValue;
}
