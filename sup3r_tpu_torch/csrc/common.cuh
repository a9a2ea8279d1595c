// Shared helpers for the port's reflect-boundary convolution kernels.
#pragma once

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
