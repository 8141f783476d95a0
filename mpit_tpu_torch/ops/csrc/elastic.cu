// Fused EASGD elastic update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mpit_tpu/ops/elastic.py `_kernel`, launched
// by `_elastic_pallas` (pl.pallas_call at elastic.py:70). Same arithmetic:
//
//     new_x[w, i] = x[w, i] - alpha * (x[w, i] - c[i])    for each worker w
//     new_c[i]    = c[i] + alpha * d[i]                   (d = sum_w (x_w - c))
//
// Bound: pure memory bandwidth. Per call it reads x (W*n), c (n) and d (n)
// and writes new_x (W*n) and new_c (n): 4 * (2W*n + 3n) bytes for 3 flops an
// element, far below the card's ~20 flop/byte balance point in f32.
//
// What the design does about that bound:
// - one pass: every input element is read once and every output written once.
//   A thread owns four consecutive elements of c/d/new_c and walks the W rows
//   of x for them, so c is read once for all W workers (the TPU kernel saw one
//   worker per device and read c once per worker) and new_c is written once.
// - 16-byte accesses: where a row's four elements are 16-byte aligned and in
//   range, they move as one float4; otherwise (a ragged tail, or rows whose
//   start is not 16-byte aligned because n % 4 != 0) they move one float at a
//   time under a mask. No padding is needed, unlike the TPU's (rows, 128) view.
// - neighbouring threads touch neighbouring 16-byte words, so every warp
//   access is coalesced.
//
// alpha is a kernel argument (the TPU version folded it in as a static).
// The launch goes on the caller's stream and does not synchronise; the
// function returns cudaGetLastError() so a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__global__ void __launch_bounds__(kThreads)
elastic_update_kernel(const float* __restrict__ x, const float* __restrict__ c,
                      const float* __restrict__ d, float* __restrict__ new_x,
                      float* __restrict__ new_c, long long n, int workers,
                      float alpha) {
  const long long i =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  const bool full = i + 4 <= n;

  float cv[4];
  if (full && aligned16(c + i) && aligned16(d + i) && aligned16(new_c + i)) {
    const float4 c4 = *reinterpret_cast<const float4*>(c + i);
    const float4 d4 = *reinterpret_cast<const float4*>(d + i);
    cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
    float4 o;
    o.x = c4.x + alpha * d4.x;
    o.y = c4.y + alpha * d4.y;
    o.z = c4.z + alpha * d4.z;
    o.w = c4.w + alpha * d4.w;
    *reinterpret_cast<float4*>(new_c + i) = o;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < n) {
        cv[k] = c[i + k];
        new_c[i + k] = cv[k] + alpha * d[i + k];
      }
    }
  }

  for (int w = 0; w < workers; ++w) {
    const float* xr = x + static_cast<long long>(w) * n + i;
    float* yr = new_x + static_cast<long long>(w) * n + i;
    if (full && aligned16(xr) && aligned16(yr)) {
      const float4 x4 = *reinterpret_cast<const float4*>(xr);
      float4 o;
      o.x = x4.x - alpha * (x4.x - cv[0]);
      o.y = x4.y - alpha * (x4.y - cv[1]);
      o.z = x4.z - alpha * (x4.z - cv[2]);
      o.w = x4.w - alpha * (x4.w - cv[3]);
      *reinterpret_cast<float4*>(yr) = o;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i + k < n) yr[k] = xr[k] - alpha * (xr[k] - cv[k]);
      }
    }
  }
}

}  // namespace

// x: (workers, n); c, d, new_c: (n,); new_x: (workers, n). All float32,
// contiguous, on the current device; the caller checks this.
extern "C" int mpit_elastic_update(const void* x, const void* c, const void* d,
                                   void* new_x, void* new_c, long long n,
                                   int workers, float alpha, void* stream) {
  if (n <= 0 || workers <= 0) return 0;
  const long long threads = (n + 3) / 4;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  elastic_update_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(c),
      static_cast<const float*>(d), static_cast<float*>(new_x),
      static_cast<float*>(new_c), n, workers, alpha);
  return static_cast<int>(cudaGetLastError());
}
