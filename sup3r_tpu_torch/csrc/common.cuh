// Shared helpers for the port's reflect-boundary convolution kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Source index of output-window cell `i` under a 1-cell reflect boundary
// (numpy/torch 'reflect': -1 -> 1, n -> n - 2; needs n >= 2). Cells
// further out are read only for masked outputs of a ragged tile, so
// they clamp into range instead of reflecting.
__device__ __forceinline__ int reflect1(int i, int n) {
    i = i < 0 ? -i : i;
    i = i >= n ? 2 * (n - 1) - i : i;
    return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float leaky(float v, int has_alpha, float alpha) {
    return (has_alpha && v < 0.f) ? alpha * v : v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A wait of
// over ~2^35 cycles (tens of seconds) traps: a fault in the pipeline
// then surfaces as a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    uint32_t done = 0;
    const long long start = clock64();
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
        if (!done && clock64() - start > (1ll << 35)) __trap();
    }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// Arrives on `bar` and expects `bytes` more to land on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// One bulk (TMA) copy of `bytes` contiguous bytes, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// One tensor (TMA) copy of the box at (c0, c1, c2, c3) of a 4D tensor
// map, completing on `bar`. `map` is a __grid_constant__ kernel
// parameter; `dst` is 128-byte aligned.
__device__ __forceinline__ void tensor_copy_4d(float* dst, const void* map,
                                               int c0, int c1, int c2,
                                               int c3, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(smem_u32(dst)), "l"(map), "r"(c0), "r"(c1), "r"(c2),
           "r"(c3), "r"(smem_u32(bar))
        : "memory");
}
