// Flash attention for Hopper (sm_90a): forward, dQ and fused dK/dV.
//
// Replaces the three Pallas TPU kernels of mpit_tpu/ops/flash_attention.py:
//   mpit_flash_forward  <- `_kernel`     (pl.pallas_call at flash_attention.py:358,
//                                          launched by `_flash_pallas`)
//   mpit_flash_dq       <- `_dq_kernel`  (pl.pallas_call at flash_attention.py:272,
//                                          launched by `_flash_pallas_bwd`)
//   mpit_flash_dkv      <- `_dkv_kernel` (pl.pallas_call at flash_attention.py:288,
//                                          launched by `_flash_pallas_bwd`)
// Same arithmetic, on (B*H, T, D) tensors, scale = 1/sqrt(D):
//   forward: S = scale * Q K^T (causal: key > query masked), online softmax,
//            O = softmax(S) V and per row LSE = m + log(l), +inf for a row no
//            key sees (its O row is 0).
//   dQ:      P = exp(S - LSE), dP = dO V^T, dS = P * (dP - dd), dQ = scale dS K,
//            with dd = rowsum(dO * O) computed by the caller.
//   dK/dV:   dV = P^T dO, dK = scale dS^T Q, per key row.
// Precision is the reference's: bf16 (or f32) inputs are widened to f32, and
// every product (Q K^T, P V, dO V^T, dS K, P^T dO, dS^T Q) accumulates in f32
// with P and dS kept in f32. Outputs are rounded once to the input dtype.
//
// Bound at the training path's shape (B*H = 96, T = 512, D = 64, bf16,
// causal), H100 SXM at 3.35 TB/s and 989 TFLOP/s bf16 dense:
//   forward  25.4 MB / 3.22 GFLOP -> 7.6 us, bytes
//   dQ       31.9 MB / 4.83 GFLOP -> 9.5 us, bytes
//   dK/dV    38.1 MB / 6.44 GFLOP -> 11.4 us, bytes
// These kernels do not approach that bound: they run their products as f32
// FMAs on the CUDA cores (67 TFLOP/s peak), which alone puts the forward's
// FLOPs at ~48 us. That is the design's choice for a first port that keeps
// the reference's f32 P; wgmma/TMA and bf16 P are later work.
//
// What the design does about the bound it does face:
// - Each input byte is read from device memory about once per block that
//   needs it; the (T, T) score matrix never leaves registers, as on the TPU.
// - A block is 128 threads owning 64 rows (of Q for forward/dQ, of K/V for
//   dK/dV). Two neighbouring lanes share a row: each holds every other
//   float4 of it in registers, so a row costs D/2 registers per operand and
//   a dot product is D/2 FMAs plus one shuffle. Interleaving the halves by
//   float4 puts the pair's shared-memory reads on neighbouring banks.
// - The other operand streams through shared memory as f32 tiles of
//   4096 floats (64 rows at D = 64), read by all lanes at once (broadcast).
// - Causal: tiles entirely above the diagonal are never loaded; the forward
//   and dQ grids start with the q-tiles that have the most keys.
// - The forward folds 16 keys at a time into the online softmax, so the
//   running max and its exp correction cost once per 16 keys.
// Blocks run independently: the TPU's sequential innermost grid axis becomes
// the loop over tiles inside a block, and nothing carries between blocks.
//
// D may be any multiple of 8 up to 128 (padded to 32, 64 or 128 inside).
// Launches go on the caller's stream without synchronising; each entry
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = kThreads / 2;  // rows per block, two lanes per row
constexpr int kTileFloats = 4096;    // shared-memory tile of the streamed operand
constexpr int kChunk = 16;           // keys per online-softmax fold
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* row, int c) {
  return *reinterpret_cast<const float4*>(row + 4 * c);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int c) {
  const uint2 raw = *reinterpret_cast<const uint2*>(row + 4 * c);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* row, int c, float4 v) {
  *reinterpret_cast<float4*>(row + 4 * c) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* row, int c, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&a);
  raw.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(row + 4 * c) = raw;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
  acc.x = fmaf(s, x.x, acc.x);
  acc.y = fmaf(s, x.y, acc.y);
  acc.z = fmaf(s, x.z, acc.z);
  acc.w = fmaf(s, x.w, acc.w);
}

__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// A row of D (padded to DP) floats lives in the lane pair as U = DP/8
// float4s per lane: lane h of the pair holds float4 chunks 2u + h.
template <int DP>
struct Row {
  static constexpr int U = DP / 8;
  float4 v[U];
};

// Load this lane's half of a global row of length d (zeros past d, or for an
// invalid row).
template <int DP, typename T>
__device__ __forceinline__ void load_row(Row<DP>& r, const T* row, int d, int h,
                                         bool valid) {
#pragma unroll
  for (int u = 0; u < Row<DP>::U; ++u) {
    const int c = 2 * u + h;
    r.v[u] = (valid && 4 * c < d) ? load4(row, c) : zero4();
  }
}

template <int DP, typename T>
__device__ __forceinline__ void store_row(T* row, const Row<DP>& r, float s, int d,
                                          int h, bool valid) {
  if (!valid) return;
#pragma unroll
  for (int u = 0; u < Row<DP>::U; ++u) {
    const int c = 2 * u + h;
    if (4 * c < d) store4(row, c, scale4(r.v[u], s));
  }
}

template <int DP>
__device__ __forceinline__ void zero_row(Row<DP>& r) {
#pragma unroll
  for (int u = 0; u < Row<DP>::U; ++u) r.v[u] = zero4();
}

// Full dot product of the pair's row with a shared-memory row (DP/4 float4s);
// every lane of the warp must call it (it shuffles).
template <int DP>
__device__ __forceinline__ float dot_row(const Row<DP>& r, const float4* srow, int h) {
  float part = 0.f;
#pragma unroll
  for (int u = 0; u < Row<DP>::U; ++u) {
    const float4 x = srow[2 * u + h];
    part = fmaf(r.v[u].x, x.x, part);
    part = fmaf(r.v[u].y, x.y, part);
    part = fmaf(r.v[u].z, x.z, part);
    part = fmaf(r.v[u].w, x.w, part);
  }
  return part + __shfl_xor_sync(kFull, part, 1);
}

template <int DP>
__device__ __forceinline__ void axpy_row(Row<DP>& acc, float s, const float4* srow,
                                         int h) {
#pragma unroll
  for (int u = 0; u < Row<DP>::U; ++u) fma4(acc.v[u], s, srow[2 * u + h]);
}

// Stage rows [r0, r0 + rows) of a (t, d) matrix into shared memory as f32,
// DP/4 float4s per row, zeros past d and past t.
template <int DP, typename T>
__device__ __forceinline__ void stage(float4* dst, const T* src, int r0, int rows,
                                      int t, int d) {
  constexpr int C4 = DP / 4;
  for (int i = threadIdx.x; i < rows * C4; i += kThreads) {
    const int r = i / C4, c = i % C4;
    dst[i] = (r0 + r < t && 4 * c < d)
                 ? load4(src + static_cast<long long>(r0 + r) * d, c)
                 : zero4();
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int t, int d, bool causal,
                     float scale) {
  constexpr int BK = kTileFloats / DP;
  constexpr int C4 = DP / 4;
  __shared__ float4 sK[BK * C4];
  __shared__ float4 sV[BK * C4];

  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first under causal
  const long long base = static_cast<long long>(blockIdx.y) * t * d;
  const int h = threadIdx.x & 1;
  const int row = qt * kRows + (threadIdx.x >> 1);
  const bool valid = row < t;

  Row<DP> qr, acc;
  load_row(qr, q + base + static_cast<long long>(row) * d, d, h, valid);
  zero_row(acc);
  float m = -CUDART_INF_F, l = 0.f;

  const int kend = causal ? min(t, (qt + 1) * kRows) : t;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    stage<DP>(sK, k + base, k0, BK, t, d);
    stage<DP>(sV, v + base, k0, BK, t, d);
    __syncthreads();
    for (int j0 = 0; j0 < BK && k0 + j0 < kend; j0 += kChunk) {
      float s[kChunk];
      float cmax = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int kr = k0 + j0 + jj;
        const float sv = dot_row<DP>(qr, sK + (j0 + jj) * C4, h) * scale;
        const bool keep = valid && kr < t && (!causal || kr <= row);
        s[jj] = keep ? sv : -CUDART_INF_F;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      // a row still fully masked keeps m = -inf: exp(s - m) would be nan, so
      // use 0 for m there (every term it touches is exp(-inf) = 0)
      const float safe_m = (m_new == -CUDART_INF_F) ? 0.f : m_new;
      const float corr = (m == -CUDART_INF_F) ? 0.f : expf(m - safe_m);
      l *= corr;
#pragma unroll
      for (int u = 0; u < Row<DP>::U; ++u) acc.v[u] = scale4(acc.v[u], corr);
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - safe_m);
        l += p;
        axpy_row<DP>(acc, p, sV + (j0 + jj) * C4, h);
      }
      m = m_new;
    }
  }

  const float lc = fmaxf(l, 1.17549435e-38f);  // float32 tiny
  store_row(o + base + static_cast<long long>(row) * d, acc, 1.f / lc, d, h, valid);
  if (valid && h == 0) {
    lse[static_cast<long long>(blockIdx.y) * t + row] =
        l > 0.f ? ((m == -CUDART_INF_F) ? 0.f : m) + logf(lc) : CUDART_INF_F;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ dd,
                T* __restrict__ dq, int t, int d, bool causal, float scale) {
  constexpr int BK = kTileFloats / DP;
  constexpr int C4 = DP / 4;
  __shared__ float4 sK[BK * C4];
  __shared__ float4 sV[BK * C4];

  const int qt = gridDim.x - 1 - blockIdx.x;
  const long long base = static_cast<long long>(blockIdx.y) * t * d;
  const int h = threadIdx.x & 1;
  const int row = qt * kRows + (threadIdx.x >> 1);
  const bool valid = row < t;
  const long long rbase = static_cast<long long>(blockIdx.y) * t + row;

  Row<DP> qr, dor, acc;
  load_row(qr, q + base + static_cast<long long>(row) * d, d, h, valid);
  load_row(dor, dout + base + static_cast<long long>(row) * d, d, h, valid);
  zero_row(acc);
  const float lse_i = valid ? lse[rbase] : CUDART_INF_F;
  const float dd_i = valid ? dd[rbase] : 0.f;

  const int kend = causal ? min(t, (qt + 1) * kRows) : t;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    stage<DP>(sK, k + base, k0, BK, t, d);
    stage<DP>(sV, v + base, k0, BK, t, d);
    __syncthreads();
    const int jend = min(BK, kend - k0);
    for (int j = 0; j < jend; ++j) {
      const int kr = k0 + j;
      const float s = dot_row<DP>(qr, sK + j * C4, h) * scale;
      const float dp = dot_row<DP>(dor, sV + j * C4, h);
      const bool keep = valid && (!causal || kr <= row);
      const float p = keep ? expf(s - lse_i) : 0.f;  // lse = +inf -> 0
      axpy_row<DP>(acc, p * (dp - dd_i), sK + j * C4, h);
    }
  }
  store_row(dq + base + static_cast<long long>(row) * d, acc, scale, d, h, valid);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 T* __restrict__ dk, T* __restrict__ dv, int t, int d,
                 bool causal, float scale) {
  constexpr int BQ = kTileFloats / DP;
  constexpr int C4 = DP / 4;
  __shared__ float4 sQ[BQ * C4];
  __shared__ float4 sO[BQ * C4];  // dO
  __shared__ float sL[BQ];
  __shared__ float sD[BQ];

  const int kt = blockIdx.x;
  const long long base = static_cast<long long>(blockIdx.y) * t * d;
  const float* lse_b = lse + static_cast<long long>(blockIdx.y) * t;
  const float* dd_b = dd + static_cast<long long>(blockIdx.y) * t;
  const int h = threadIdx.x & 1;
  const int krow = kt * kRows + (threadIdx.x >> 1);
  const bool valid = krow < t;

  Row<DP> kr, vr, dka, dva;
  load_row(kr, k + base + static_cast<long long>(krow) * d, d, h, valid);
  load_row(vr, v + base + static_cast<long long>(krow) * d, d, h, valid);
  zero_row(dka);
  zero_row(dva);

  // causal: queries before this block's first key see none of its keys
  const int qfirst = causal ? kt * kRows : 0;
  for (int q0 = qfirst / BQ * BQ; q0 < t; q0 += BQ) {
    __syncthreads();
    stage<DP>(sQ, q + base, q0, BQ, t, d);
    stage<DP>(sO, dout + base, q0, BQ, t, d);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      sL[i] = q0 + i < t ? lse_b[q0 + i] : CUDART_INF_F;
      sD[i] = q0 + i < t ? dd_b[q0 + i] : 0.f;
    }
    __syncthreads();
    const int istart = max(0, qfirst - q0);
    const int iend = min(BQ, t - q0);
    for (int i = istart; i < iend; ++i) {
      const int qi = q0 + i;
      const float s = dot_row<DP>(kr, sQ + i * C4, h) * scale;
      const float dpt = dot_row<DP>(vr, sO + i * C4, h);
      const bool keep = valid && (!causal || krow <= qi);
      const float p = keep ? expf(s - sL[i]) : 0.f;
      axpy_row<DP>(dva, p, sO + i * C4, h);
      axpy_row<DP>(dka, p * (dpt - sD[i]), sQ + i * C4, h);
    }
  }
  store_row(dk + base + static_cast<long long>(krow) * d, dka, scale, d, h, valid);
  store_row(dv + base + static_cast<long long>(krow) * d, dva, 1.f, d, h, valid);
}

template <typename T, int DP>
cudaError_t forward(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int t, int d, bool causal, cudaStream_t s) {
  const dim3 grid((t + kRows - 1) / kRows, bh);
  flash_forward_kernel<T, DP><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), t, d, causal,
      1.f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dd, void* dqo, int bh, int t, int d,
               bool causal, cudaStream_t s) {
  const dim3 grid((t + kRows - 1) / kRows, bh);
  flash_dq_kernel<T, DP><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<T*>(dqo), t, d, causal,
      1.f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* dd, void* dko, void* dvo, int bh,
                int t, int d, bool causal, cudaStream_t s) {
  const dim3 grid((t + kRows - 1) / kRows, bh);
  flash_dkv_kernel<T, DP><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<T*>(dko), static_cast<T*>(dvo), t,
      d, causal, 1.f / sqrtf(static_cast<float>(d)));
  return cudaGetLastError();
}

// Pick the padded width and the element type; d is checked by the caller.
#define MPIT_FLASH_DISPATCH(FN, ...)                                       \
  do {                                                                     \
    if (bf16) {                                                            \
      if (d <= 32) return FN<__nv_bfloat16, 32>(__VA_ARGS__);              \
      if (d <= 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);              \
      return FN<__nv_bfloat16, 128>(__VA_ARGS__);                          \
    }                                                                      \
    if (d <= 32) return FN<float, 32>(__VA_ARGS__);                        \
    if (d <= 64) return FN<float, 64>(__VA_ARGS__);                        \
    return FN<float, 128>(__VA_ARGS__);                                    \
  } while (0)

int run_checks(int bh, int t, int d) {
  if (bh <= 0 || t <= 0) return -1;  // nothing to do
  if (d <= 0 || d > 128 || d % 8 != 0 || bh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// All tensors (B*H, T, D) contiguous, of one dtype (bf16 if `bf16`, else
// f32), 16-byte aligned; lse and dd (B*H, T) f32. The caller checks this.
extern "C" int mpit_flash_forward(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int t, int d,
                                  int causal, int bf16, void* stream) {
  const int c = run_checks(bh, t, d);
  if (c != 0) return c < 0 ? 0 : c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&]() -> cudaError_t {
    MPIT_FLASH_DISPATCH(forward, q, k, v, o, lse, bh, t, d, causal != 0, s);
  };
  return static_cast<int>(go());
}

extern "C" int mpit_flash_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* dd,
                             void* dqo, int bh, int t, int d, int causal, int bf16,
                             void* stream) {
  const int c = run_checks(bh, t, d);
  if (c != 0) return c < 0 ? 0 : c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&]() -> cudaError_t {
    MPIT_FLASH_DISPATCH(dq, q, k, v, dout, lse, dd, dqo, bh, t, d, causal != 0, s);
  };
  return static_cast<int>(go());
}

extern "C" int mpit_flash_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* dd,
                              void* dko, void* dvo, int bh, int t, int d,
                              int causal, int bf16, void* stream) {
  const int c = run_checks(bh, t, d);
  if (c != 0) return c < 0 ? 0 : c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&]() -> cudaError_t {
    MPIT_FLASH_DISPATCH(dkv, q, k, v, dout, lse, dd, dko, dvo, bh, t, d,
                        causal != 0, s);
  };
  return static_cast<int>(go());
}
