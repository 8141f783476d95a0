// Fused EASGD elastic update for Hopper (sm_90a), all leaves of a tree in
// one launch.
//
// Replaces the Pallas TPU kernel mpit_tpu/ops/elastic.py `_kernel`, launched
// by `_elastic_pallas` (pl.pallas_call at elastic.py:70). Same arithmetic,
// for every leaf:
//
//     new_x[w, i] = x[w, i] - alpha * (x[w, i] - c[i])    for each worker w
//     new_c[i]    = c[i] + alpha * d[i]                   (d = sum_w (x_w - c))
//
// Bound: pure memory bandwidth. Per leaf it reads x (W*n), c (n) and d (n)
// and writes new_x (W*n) and new_c (n): 4 * (2W*n + 3n) bytes for 3 flops an
// element, far below the card's ~20 flop/byte balance point in f32.
//
// What the design does about that bound:
// - one launch for many leaves: the leaves travel as a table in one by-value
//   kernel parameter (__grid_constant__, read from the constant bank; no
//   host-to-device copy). For each leaf it holds the five pointers, n and the
//   index of the leaf's first block. A block finds its leaf by a binary
//   search of those indices and works inside that leaf only. A tree with
//   more leaves than the table holds (kMaxLeaves) takes one launch per group.
//   A round of small leaves so pays one launch, not one per leaf.
// - one pass: every input element is read once and every output written once.
//   A thread owns four consecutive elements of c/d/new_c and walks the W rows
//   of x for them, so c is read once for all W workers (the TPU kernel saw one
//   worker per device and read c once per worker) and new_c is written once.
// - 16-byte accesses: where a row's four elements are 16-byte aligned and in
//   range, they move as one float4; otherwise (a ragged tail, or rows whose
//   start is not 16-byte aligned because n % 4 != 0 or the leaf starts
//   unaligned) they move one float at a time under a mask. No padding is
//   needed, unlike the TPU's (rows, 128) view.
// - neighbouring threads touch neighbouring 16-byte words, so every warp
//   access is coalesced.
//
// Rounding: every difference, product and sum is rounded on its own
// (__fsub_rn, __fmul_rn, __fadd_rn, which the compiler never contracts into a
// fused multiply-add), so each move is bit for bit what PyTorch's separate
// ops compute (the plain version, ops/elastic.py) and what numpy computes in
// the host-async parameter server and its clients (parallel/pserver.py,
// parallel/ps_roles.py). The two EASGD runtimes then agree to the bit at the
// exchange.
//
// In place: new_x == x and new_c == c are allowed (the trainers' donated
// state; ops/elastic.py passes the input pointers as outputs). Each element
// is read and written by one thread only, and that thread loads c[i..i+3]
// into cv before it stores new_c, and loads each x row before it stores
// that row, so no value is read after it was overwritten. Nothing here may
// assume otherwise: the Leaf pointers carry no __restrict__, so the
// compiler neither reorders a load past an aliasing store nor reads the
// inputs through the read-only cache.
//
// alpha is a kernel argument (the TPU version folded it in as a static).
// Launches go on the caller's stream and do not synchronise; each entry
// returns cudaGetLastError() so a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 32;  // 32 x 56 bytes of table, inside the 4 KB of parameters

struct Leaf {
  const float* x;  // (workers, n)
  const float* c;  // (n,)
  const float* d;  // (n,)
  float* new_x;    // (workers, n)
  float* new_c;    // (n,)
  long long n;
  long long first_block;
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int count;
  int workers;
  float alpha;
};

__device__ __forceinline__ float center_move(float c, float d, float alpha) {
  return __fadd_rn(c, __fmul_rn(alpha, d));
}

__device__ __forceinline__ float client_move(float x, float c, float alpha) {
  return __fsub_rn(x, __fmul_rn(alpha, __fsub_rn(x, c)));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__global__ void __launch_bounds__(kThreads)
elastic_update_kernel(const __grid_constant__ Leaves table) {
  // the last leaf whose first block is at or before this one
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].first_block <= blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const Leaf& leaf = table.leaf[lo];
  const long long n = leaf.n;
  const float alpha = table.alpha;
  const long long i =
      ((static_cast<long long>(blockIdx.x) - leaf.first_block) * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
  const bool full = i + 4 <= n;
  const float* c = leaf.c;
  const float* d = leaf.d;
  float* new_c = leaf.new_c;

  float cv[4];
  if (full && aligned16(c + i) && aligned16(d + i) && aligned16(new_c + i)) {
    const float4 c4 = *reinterpret_cast<const float4*>(c + i);
    const float4 d4 = *reinterpret_cast<const float4*>(d + i);
    cv[0] = c4.x; cv[1] = c4.y; cv[2] = c4.z; cv[3] = c4.w;
    float4 o;
    o.x = center_move(c4.x, d4.x, alpha);
    o.y = center_move(c4.y, d4.y, alpha);
    o.z = center_move(c4.z, d4.z, alpha);
    o.w = center_move(c4.w, d4.w, alpha);
    *reinterpret_cast<float4*>(new_c + i) = o;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (i + k < n) {
        cv[k] = c[i + k];
        new_c[i + k] = center_move(cv[k], d[i + k], alpha);
      }
    }
  }

  for (int w = 0; w < table.workers; ++w) {
    const float* xr = leaf.x + static_cast<long long>(w) * n + i;
    float* yr = leaf.new_x + static_cast<long long>(w) * n + i;
    if (full && aligned16(xr) && aligned16(yr)) {
      const float4 x4 = *reinterpret_cast<const float4*>(xr);
      float4 o;
      o.x = client_move(x4.x, cv[0], alpha);
      o.y = client_move(x4.y, cv[1], alpha);
      o.z = client_move(x4.z, cv[2], alpha);
      o.w = client_move(x4.w, cv[3], alpha);
      *reinterpret_cast<float4*>(yr) = o;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i + k < n) yr[k] = client_move(xr[k], cv[k], alpha);
      }
    }
  }
}

}  // namespace

// For each of `leaves` leaves l: x[l] (workers, n[l]); c[l], d[l], new_c[l]
// (n[l],); new_x[l] (workers, n[l]). All float32, contiguous, 4-byte aligned,
// on the current device; the caller checks this. Empty leaves are skipped;
// the rest go in groups of up to kMaxLeaves, one launch each.
extern "C" int mpit_elastic_update_leaves(const void* const* x, const void* const* c,
                                          const void* const* d, void* const* new_x,
                                          void* const* new_c, const long long* n,
                                          int leaves, int workers, float alpha,
                                          void* stream) {
  if (workers <= 0) return 0;
  Leaves table;
  table.workers = workers;
  table.alpha = alpha;
  int l = 0;
  while (l < leaves) {
    table.count = 0;
    long long blocks = 0;
    for (; l < leaves && table.count < kMaxLeaves; ++l) {
      if (n[l] <= 0) continue;
      table.leaf[table.count++] = Leaf{
          static_cast<const float*>(x[l]), static_cast<const float*>(c[l]),
          static_cast<const float*>(d[l]), static_cast<float*>(new_x[l]),
          static_cast<float*>(new_c[l]), n[l], blocks};
      blocks += ((n[l] + 3) / 4 + kThreads - 1) / kThreads;
    }
    if (table.count == 0) break;
    elastic_update_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(table);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// One leaf: x (workers, n); c, d, new_c (n,); new_x (workers, n).
extern "C" int mpit_elastic_update(const void* x, const void* c, const void* d,
                                   void* new_x, void* new_c, long long n,
                                   int workers, float alpha, void* stream) {
  return mpit_elastic_update_leaves(&x, &c, &d, &new_x, &new_c, &n, 1, workers, alpha,
                                    stream);
}
