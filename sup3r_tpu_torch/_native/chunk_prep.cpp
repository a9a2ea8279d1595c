// Host-side chunk preparation kernels for sup3r_tpu_torch.
//
// These are the host hot paths that feed the device during continental
// inference and training:
//   * reflect_pad_4d: boundary halo padding of (s1, s2, t, f) chunks
//     (numpy's generic np.pad is single-threaded and allocation-heavy)
//   * gather_scale_transpose: one fused pass turning a rex-style
//     (time, sites) uint16/float block + gid list into a scaled
//     (s1, s2, t) float32 raster — the inner loop of every flattened
//     H5 read (loader -> rasterizer path).
//   * idw_apply: apply a precomputed inverse-distance-weight stencil
//     (regridding hot loop in DualRasterizer).
//
// Exposed with plain C linkage for ctypes. Parallelized with a simple
// std::thread pool over the outer dimension.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// run fn(i) for i in [0, n) over hardware threads
template <typename F>
void parallel_for(int64_t n, F fn) {
  unsigned n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 4;
  n_threads = std::min<int64_t>(n_threads, n);
  if (n_threads <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (unsigned t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n);
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

// reflect index (numpy 'reflect' mode: no repeated edge)
inline int64_t reflect(int64_t idx, int64_t n) {
  if (n == 1) return 0;
  int64_t period = 2 * (n - 1);
  idx = ((idx % period) + period) % period;
  return idx < n ? idx : period - idx;
}

}  // namespace

extern "C" {

// in:  (s1, s2, t, f) float32, C-contiguous
// out: (s1 + p1a + p1b, s2 + p2a + p2b, t + pta + ptb, f) float32
void reflect_pad_4d(const float* in, float* out, int64_t s1, int64_t s2,
                    int64_t t, int64_t f, int64_t p1a, int64_t p1b,
                    int64_t p2a, int64_t p2b, int64_t pta,
                    int64_t ptb) {
  const int64_t o1 = s1 + p1a + p1b;
  const int64_t o2 = s2 + p2a + p2b;
  const int64_t ot = t + pta + ptb;
  const int64_t in_row = s2 * t * f;
  const int64_t out_row = o2 * ot * f;

  parallel_for(o1, [=](int64_t i) {
    const int64_t si = reflect(i - p1a, s1);
    const float* in_i = in + si * in_row;
    float* out_i = out + i * out_row;
    for (int64_t j = 0; j < o2; ++j) {
      const int64_t sj = reflect(j - p2a, s2);
      const float* in_ij = in_i + sj * t * f;
      float* out_ij = out_i + j * ot * f;
      if (pta == 0 && ptb == 0) {
        std::memcpy(out_ij, in_ij, sizeof(float) * t * f);
      } else {
        for (int64_t k = 0; k < ot; ++k) {
          const int64_t sk = reflect(k - pta, t);
          std::memcpy(out_ij + k * f, in_ij + sk * f,
                      sizeof(float) * f);
        }
      }
    }
  });
}

// src: (time, n_sites_total) uint16 (or int16) block already read
// from h5; gids: (s1*s2,) int64 column indices; out: (s1*s2, time)
// float32 scaled by 1/scale. The transpose turns rex layout into the
// framework's space-leading layout in one pass.
void gather_scale_transpose_u16(const uint16_t* src, const int64_t* gids,
                                float* out, int64_t time,
                                int64_t n_sites_total, int64_t n_out,
                                float inv_scale) {
  parallel_for(n_out, [=](int64_t s) {
    const int64_t g = gids[s];
    float* row = out + s * time;
    for (int64_t k = 0; k < time; ++k) {
      row[k] = static_cast<float>(src[k * n_sites_total + g]) *
               inv_scale;
    }
  });
}

void gather_scale_transpose_f32(const float* src, const int64_t* gids,
                                float* out, int64_t time,
                                int64_t n_sites_total, int64_t n_out,
                                float inv_scale) {
  parallel_for(n_out, [=](int64_t s) {
    const int64_t g = gids[s];
    float* row = out + s * time;
    for (int64_t k = 0; k < time; ++k) {
      row[k] = src[k * n_sites_total + g] * inv_scale;
    }
  });
}

// apply an IDW stencil: out[n, ...] = sum_k w[n,k] * src[idx[n,k], ...]
// src: (n_src, m) f32; idx: (n_out, k) int64; w: (n_out, k) f32;
// out: (n_out, m) f32
void idw_apply(const float* src, const int64_t* idx, const float* w,
               float* out, int64_t n_out, int64_t k, int64_t m) {
  parallel_for(n_out, [=](int64_t n) {
    float* row = out + n * m;
    std::memset(row, 0, sizeof(float) * m);
    for (int64_t j = 0; j < k; ++j) {
      const float wj = w[n * k + j];
      const float* s = src + idx[n * k + j] * m;
      for (int64_t c = 0; c < m; ++c) row[c] += wj * s[c];
    }
  });
}

}  // extern "C"
