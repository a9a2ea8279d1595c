// Reflect-pad-1 + k3/s1 3D convolution + bias (+ LeakyReLU) for tiny
// channel counts (ci * co <= 32), the flagship generator's HR 8 -> 2
// tail conv.
//
// Replaces: sup3r_tpu/ops/pallas_kernels.py::_small_conv_core (Pallas
// body _small_conv_kernel), reached through small_reflect_conv.
//
// Bound on an H100 SXM: bytes and operations alike. At the flagship
// tail, x (16, 8, 60, 60, 96) -> y (16, 2, 60, 60, 96), it must read
// 176.9 MB and write 44.2 MB (~66 us at 3.35 TB/s) for 4.78 GFLOP
// (~71 us at 67 TFLOP/s fp32), so neither side has slack to waste.
//
// Design: one thread per output voxel (b, h, w, t) with t across
// neighbouring threads, so every tap load of a warp is one coalesced
// 128-byte row. The thread loops over CI and the 27 taps itself (the
// TPU kernel carried that sum across a sequential CI grid axis, which
// Hopper's unordered blocks cannot do), keeps the CO fp32 accumulators
// in registers (the kernel is templated on CO), and computes the reflect
// halo with index math, so the padded tensor is never materialised. The
// 27 taps re-read each input value from L1/L2, not from device memory.
// Bias and LeakyReLU are applied in the epilogue. Weights arrive as
// (CI, 3, 3, 3, CO) and are staged in shared memory once per block.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int CO>
__global__ void __launch_bounds__(kThreads)
small_reflect_conv_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          float* __restrict__ y, int B, int CI, int H,
                          int W, int T, int has_alpha, float alpha) {
    extern __shared__ float w_s[];  // (CI, 27, CO)
    const int n_w = CI * 27 * CO;
    for (int i = threadIdx.x; i < n_w; i += blockDim.x) w_s[i] = w[i];
    __syncthreads();

    const long long n_out = (long long)B * H * W * T;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n_out) return;
    const int t = (int)(idx % T);
    long long r = idx / T;
    const int wi = (int)(r % W);
    r /= W;
    const int h = (int)(r % H);
    const int b = (int)(r / H);

    int hh[3], ww[3], tt[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        hh[k] = reflect1(h + k - 1, H);
        ww[k] = reflect1(wi + k - 1, W);
        tt[k] = reflect1(t + k - 1, T);
    }

    float acc[CO];
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[co] = 0.f;

    const long long plane = (long long)H * W * T;
    for (int ci = 0; ci < CI; ++ci) {
        const float* xc = x + ((long long)b * CI + ci) * plane;
        const float* wc = w_s + ci * 27 * CO;
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
            for (int dw = 0; dw < 3; ++dw) {
                const float* row = xc + ((long long)hh[dh] * W + ww[dw]) * T;
#pragma unroll
                for (int dt = 0; dt < 3; ++dt) {
                    const float v = __ldg(row + tt[dt]);
                    const float* wt = wc + ((dh * 3 + dw) * 3 + dt) * CO;
#pragma unroll
                    for (int co = 0; co < CO; ++co)
                        acc[co] = fmaf(v, wt[co], acc[co]);
                }
            }
        }
    }

    const long long out_base = (long long)b * CO * plane
        + ((long long)h * W + wi) * T + t;
#pragma unroll
    for (int co = 0; co < CO; ++co)
        y[out_base + co * plane] = leaky(acc[co] + bias[co], has_alpha, alpha);
}

}  // namespace

// x (B, CI, H, W, T), w (CI, 3, 3, 3, CO), bias (CO,), y (B, CO, H, W, T);
// all fp32, contiguous, on `device`. Returns the cudaError_t of the launch.
extern "C" int small_reflect_conv_f32(const float* x, const float* w,
                                      const float* bias, float* y, int B,
                                      int CI, int H, int W, int T, int CO,
                                      int has_alpha, float alpha, int device,
                                      void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const long long n_out = (long long)B * H * W * T;
    const unsigned blocks = (unsigned)((n_out + kThreads - 1) / kThreads);
    const size_t smem = (size_t)CI * 27 * CO * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (CO) {
#define SMALL_CONV_CASE(N)                                                  \
    case N:                                                                 \
        small_reflect_conv_kernel<N><<<blocks, kThreads, smem, s>>>(        \
            x, w, bias, y, B, CI, H, W, T, has_alpha, alpha);               \
        break;
        SMALL_CONV_CASE(1) SMALL_CONV_CASE(2) SMALL_CONV_CASE(3)
        SMALL_CONV_CASE(4) SMALL_CONV_CASE(5) SMALL_CONV_CASE(6)
        SMALL_CONV_CASE(7) SMALL_CONV_CASE(8) SMALL_CONV_CASE(9)
        SMALL_CONV_CASE(10) SMALL_CONV_CASE(11) SMALL_CONV_CASE(12)
        SMALL_CONV_CASE(13) SMALL_CONV_CASE(14) SMALL_CONV_CASE(15)
        SMALL_CONV_CASE(16) SMALL_CONV_CASE(17) SMALL_CONV_CASE(18)
        SMALL_CONV_CASE(19) SMALL_CONV_CASE(20) SMALL_CONV_CASE(21)
        SMALL_CONV_CASE(22) SMALL_CONV_CASE(23) SMALL_CONV_CASE(24)
        SMALL_CONV_CASE(25) SMALL_CONV_CASE(26) SMALL_CONV_CASE(27)
        SMALL_CONV_CASE(28) SMALL_CONV_CASE(29) SMALL_CONV_CASE(30)
        SMALL_CONV_CASE(31) SMALL_CONV_CASE(32)
#undef SMALL_CONV_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
