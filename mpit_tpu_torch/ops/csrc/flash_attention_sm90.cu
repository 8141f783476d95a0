// Flash attention on Hopper's tensor cores (sm_90a): forward, dQ and fused
// dK/dV with wgmma, P and dS rounded to bf16 for their products.
//
// Replaces the three Pallas TPU kernels of mpit_tpu/ops/flash_attention.py:
//   mpit_flash_forward_sm90 <- `_kernel`     (pl.pallas_call at flash_attention.py:358,
//                                              launched by `_flash_pallas`)
//   mpit_flash_dq_sm90      <- `_dq_kernel`  (pl.pallas_call at flash_attention.py:272,
//                                              launched by `_flash_pallas_bwd`)
//   mpit_flash_dkv_sm90     <- `_dkv_kernel` (pl.pallas_call at flash_attention.py:288,
//                                              launched by `_flash_pallas_bwd`)
// and, on the inputs they take, the CUDA-core kernels of flash_attention.cu.
// Same functions on (B*H, T, D) tensors, scale = 1/sqrt(D):
//   forward: S = scale * Q K^T (causal: key > query masked), online softmax,
//            O = softmax(S) V in bf16 and per row an f32 LSE = m + log(l),
//            +inf for a row no key sees (its O row is 0).
//   dQ:      P = exp(S - LSE), dP = dO V^T, dS = P * (dP - dd),
//            dQ = scale dS K, with dd = rowsum(dO * O) from the caller.
//   dK/dV:   the same P and dS transposed, dV = P^T dO, dK = scale dS^T Q.
// Gradients are written in bf16. dQ and dK/dV stay two kernels, as the
// reference keeps two pallas_calls: each output tile has one owner block, so
// no atomics and no f32 scratch. They take bf16, D = 64 and T % 64 == 0 only;
// the wrapper sends anything else to flash_attention.cu.
//
// Precision: every product runs on the tensor cores as bf16 x bf16 with f32
// accumulation. Q K^T, dO V^T, V dO^T take the bf16 inputs as they are, as
// the reference's MXU products do. P (forward and dK/dV) and dS (dQ and
// dK/dV) are computed in f32 and rounded to bf16 before P V, P^T dO, dS K and
// dS^T Q, where the reference keeps them in f32: FlashAttention 2 and 3
// round the same way. Softmax statistics, the LSE and every sum stay f32.
//
// Bound at the training path's shape (B*H = 96, T = 512, D = 64, bf16,
// causal), H100 SXM at 3.35 TB/s and 989 TFLOP/s bf16 dense:
//   forward  25.4 MB / 3.22 GFLOP -> 7.6 us, bytes (3.3 us of FLOPs)
//   dQ       31.9 MB / 4.83 GFLOP -> 9.5 us, bytes (4.9 us of FLOPs)
//   dK/dV    38.1 MB / 6.44 GFLOP -> 11.4 us, bytes (6.5 us of FLOPs)
//
// Design. A block is one warpgroup (128 threads) that owns 64 rows: query
// rows for the forward and dQ, key rows for dK/dV. The operand it streams (K
// and V, or Q, dO, LSE and dd) comes in tiles of 64 rows through shared
// memory, double-buffered with cp.async, so the next tile's copy runs under
// this tile's products. Every tile is stored as it lies in device memory, a
// (64, 64) bf16 row-major block whose 128-byte rows are swizzled (16-byte
// chunk c of row r at chunk c ^ (r % 8)), 1024-byte aligned. That one layout
// serves both operand forms of wgmma:
//   K-major (D is the reduction: Q and K in Q K^T, dO and V in dO V^T, K and
//   Q in K Q^T, V and dO in V dO^T): the k-th 16-wide slice starts 32 bytes
//   further.
//   MN-major (the tile's rows are the reduction: V in P V, K in dS K, dO in
//   P^T dO, Q in dS^T Q), with wgmma's transpose bit: the k-th slice of 16
//   rows starts 2048 bytes further.
// The scores come out of wgmma in its accumulator layout; P (or dS) is
// rounded to bf16 and repacked in registers straight into the A-operand
// layout of the next wgmma (the accumulator's 16-column slice k is exactly
// the A fragment of reduction slice k), so P never touches shared memory.
// dQ and dK/dV issue their two score products (S and dP) as two commit
// groups and compute P while the second runs. Row max and row sum reduce
// over the 4 lanes that share a row. Causal: tiles entirely above the
// diagonal are skipped; only the diagonal tile is masked, by each
// accumulator element's (row, col). The forward and dQ grids start with the
// query tiles that have the most keys; a dK/dV block starts its loop at its
// own first key. Blocks run independently: the TPU's sequential innermost
// grid axis is the loop over tiles inside a block.
//
// Launches go on the caller's stream without synchronising; each entry
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                 // head dim
constexpr int kTile = 64;              // rows of every tile
constexpr int kTileBytes = kTile * kD * 2;
constexpr int kThreads = 128;          // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async writes shared memory through the generic proxy, wgmma reads it
// through the async proxy: each writer fences before the barrier.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy rows [0, 64) of a (64, 64) bf16 block at src into a swizzled tile.
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src) {
#pragma unroll
  for (int n = 0; n < kTile * 8 / kThreads; ++n) {
    const int i = threadIdx.x + n * kThreads, r = i >> 3, c = i & 7;
    cp_async16(tile + r * 128 + ((c ^ (r & 7)) << 4), src + r * kD + c * 8);
  }
}

// Copy 64 floats (256 bytes) with 16 threads.
__device__ __forceinline__ void load_row64(uint32_t dst, const float* src, int lane16) {
  cp_async16(dst + 16 * lane16, src + 4 * lane16);
}

// wgmma's shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor
// Format"): start address, leading and stride byte offsets, each >> 4, and
// the layout type in bits 62-63 (1: 128-byte swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major: 8-row groups 1024 bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int k) {
  return make_desc(tile + 32 * k, 16, 1024);
}

// MN-major (transposed): 8-row groups of the reduction 1024 bytes apart. A
// 64-wide swizzle atom spans all of N = 64, so the offset between atoms is
// unused; it is given the same 1024.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int k) {
  return make_desc(tile + 2048 * k, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After a wait: later uses of the accumulator depend on this, so the
// compiler cannot move them above the wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MPIT_ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),      \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),         \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),         \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),         \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define MPIT_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// D (64 x 64, f32) = A B (+ D if accumulate), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MPIT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MPIT_ACC32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// D += A B, A (64 x 16, bf16) in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MPIT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MPIT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Accumulator layout of m64nNk16 (f32): in warp w, lane l, element 4i + e
// sits at row 16w + l/4 + 8(e/2), column 8i + 2(l%4) + e%2. The 16 columns
// [16k, 16k + 16) of a row pair are elements 8k..8k+7, which, rounded to
// bf16 in this order, are the A fragment of reduction slice k.
__device__ __forceinline__ void to_a_fragments(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * k + h;
      a[k][2 * h] = pack_bf16(x[4 * i], x[4 * i + 1]);
      a[k][2 * h + 1] = pack_bf16(x[4 * i + 2], x[4 * i + 3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store a 64 x 64 f32 accumulator, times s[row pair], as bf16 rows
// [0, 64) of dst (row stride kD).
__device__ __forceinline__ void store_acc(bf16* dst, const float (&x)[32], float s0, float s1) {
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    *reinterpret_cast<uint32_t*>(dst + r * kD + 8 * i + c) =
        pack_bf16(x[4 * i] * s0, x[4 * i + 1] * s0);
    *reinterpret_cast<uint32_t*>(dst + (r + 8) * kD + 8 * i + c) =
        pack_bf16(x[4 * i + 2] * s1, x[4 * i + 3] * s1);
  }
}

constexpr int kFwdSmem = 5 * kTileBytes + 1024;  // Q, K x2, V x2, alignment

__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int t, bool causal, float scale_log2) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const auto sK = [&](int s) { return base + (1 + s) * kTileBytes; };
  const auto sV = [&](int s) { return base + (3 + s) * kTileBytes; };

  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first under causal
  const long long off = static_cast<long long>(blockIdx.y) * t * kD;
  const bf16* kb = k + off;
  const bf16* vb = v + off;
  const int n_tiles = causal ? qt + 1 : t / kTile;

  load_tile(sQ, q + off + static_cast<long long>(qt) * kTile * kD);
  load_tile(sK(0), kb);
  load_tile(sV(0), vb);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);  // rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max, log2 domain
  float l[2] = {0.f, 0.f};                      // this lane's part of the row sum

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    if (j + 1 < n_tiles) {
      const long long next = static_cast<long long>(j + 1) * kTile * kD;
      load_tile(sK(s ^ 1), kb + next);
      load_tile(sV(s ^ 1), vb + next);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, desc_k(sQ, kk), desc_k(sK(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    const bool diag = causal && j == qt;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * i + e] * scale_log2;
        if (diag && 8 * i + c0 + (e & 1) > r0 + 8 * (e >> 1)) x = -CUDART_INF_F;
        sc[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mref[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      // a row still fully masked keeps m = -inf: exp2(x - m) would be nan,
      // so subtract 0 there (every term it touches is exp2(-inf) = 0)
      mref[h] = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float corr = m[h] == -CUDART_INF_F ? 0.f : exp2f(m[h] - mref[h]);
      l[h] *= corr;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[4 * i + 2 * h] *= corr;
        acc[4 * i + 2 * h + 1] *= corr;
      }
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * i + e] - mref[e >> 1]);
        l[e >> 1] += p;
        sc[4 * i + e] = p;
      }
    }
    uint32_t pa[4][4];
    to_a_fragments(sc, pa);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, pa[kk], desc_mn(sV(s), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every lane is done with stage s before it is refilled
  }

  float inv[2];
  const long long row0 = static_cast<long long>(qt) * kTile;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
    if ((lane & 3) == 0) {
      lse[static_cast<long long>(blockIdx.y) * t + row0 + r0 + 8 * h] =
          l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : CUDART_INF_F;
    }
  }
  store_acc(o + off + row0 * kD, acc, inv[0], inv[1]);
}

// Q and dO x2 after K and V, then LSE and dd rows x2, then alignment.
constexpr int kDkvSmem = 6 * kTileBytes + 4 * kTile * 4 + 1024;

__global__ void __launch_bounds__(kThreads)
flash_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ dd,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int t,
                       bool causal, float scale, float scale_log2) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  uint8_t* const gbase = smem + (base - smem_addr(smem));  // generic pointer
  const uint32_t sK = base, sV = base + kTileBytes;
  const auto sQ = [&](int s) { return base + (2 + s) * kTileBytes; };
  const auto sO = [&](int s) { return base + (4 + s) * kTileBytes; };  // dO
  const uint32_t rows_off = 6 * kTileBytes;  // LSE[s] at +256 s, dd[s] at +512 + 256 s
  const float* sL = reinterpret_cast<const float*>(gbase + rows_off);
  const float* sD = sL + 2 * kTile;

  const int kt = blockIdx.x;
  const long long off = static_cast<long long>(blockIdx.y) * t * kD;
  const float* lse_b = lse + static_cast<long long>(blockIdx.y) * t;
  const float* dd_b = dd + static_cast<long long>(blockIdx.y) * t;
  const int q_first = causal ? kt : 0;  // earlier queries see none of these keys
  const int n_tiles = t / kTile;

  const auto load_q_tile = [&](int j, int s) {
    const long long at = static_cast<long long>(j) * kTile * kD;
    load_tile(sQ(s), q + off + at);
    load_tile(sO(s), dout + off + at);
    if (threadIdx.x < 16) {
      load_row64(base + rows_off + 256 * s, lse_b + j * kTile, threadIdx.x);
    } else if (threadIdx.x < 32) {
      load_row64(base + rows_off + 512 + 256 * s, dd_b + j * kTile, threadIdx.x - 16);
    }
  };

  load_tile(sK, k + off + static_cast<long long>(kt) * kTile * kD);
  load_tile(sV, v + off + static_cast<long long>(kt) * kTile * kD);
  load_q_tile(q_first, 0);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);  // key rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);                          // query column of element 4i

  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int j = q_first; j < n_tiles; ++j) {
    const int s = (j - q_first) & 1;
    if (j + 1 < n_tiles) {
      load_q_tile(j + 1, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries each
    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(st, desc_k(sK, kk), desc_k(sQ(s), kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dpt, desc_k(sV, kk), desc_k(sO(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S^T is ready; dP^T may still run
    fence_regs(st);

    const float* L = sL + kTile * s;
    const float* Dd = sD + kTile * s;
    const bool diag = causal && j == kt;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 lq = *reinterpret_cast<const float2*>(L + 8 * i + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lse_q = (e & 1) ? lq.y : lq.x;
        float p = exp2f(st[4 * i + e] * scale_log2 - lse_q * kLog2e);  // LSE +inf -> 0
        if (diag && r0 + 8 * (e >> 1) > 8 * i + c0 + (e & 1)) p = 0.f;  // key > query
        st[4 * i + e] = p;
      }
    }
    uint32_t pa[4][4];
    to_a_fragments(st, pa);

    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 dq = *reinterpret_cast<const float2*>(Dd + 8 * i + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - ((e & 1) ? dq.y : dq.x));
      }
    }
    uint32_t da[4][4];
    to_a_fragments(dpt, da);

    // dV += P^T dO and dK += dS^T Q, dO and Q as the MN-major operand
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dv_acc, pa[kk], desc_mn(sO(s), kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(dk_acc, da[kk], desc_mn(sQ(s), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // every lane is done with stage s before it is refilled
  }

  const long long at = off + static_cast<long long>(kt) * kTile * kD;
  store_acc(dk + at, dk_acc, scale, scale);
  store_acc(dv + at, dv_acc, 1.f, 1.f);
}

constexpr int kDqSmem = 6 * kTileBytes + 1024;  // Q, dO, K x2, V x2, alignment

__global__ void __launch_bounds__(kThreads)
flash_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dd,
                      bf16* __restrict__ dq, int t, bool causal, float scale,
                      float scale_log2) {
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t sQ = base, sO = base + kTileBytes;  // sO holds dO
  const auto sK = [&](int s) { return base + (2 + s) * kTileBytes; };
  const auto sV = [&](int s) { return base + (4 + s) * kTileBytes; };

  const int qt = gridDim.x - 1 - blockIdx.x;  // most keys first under causal
  const long long off = static_cast<long long>(blockIdx.y) * t * kD;
  const long long row0 = static_cast<long long>(qt) * kTile;
  const bf16* kb = k + off;
  const bf16* vb = v + off;
  const int n_tiles = causal ? qt + 1 : t / kTile;

  load_tile(sQ, q + off + row0 * kD);
  load_tile(sO, dout + off + row0 * kD);
  load_tile(sK(0), kb);
  load_tile(sV(0), vb);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);  // query rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);                          // key column of element 4i
  // this thread's two rows: LSE in the log2 domain (+inf stays +inf), dd
  const long long at_row = static_cast<long long>(blockIdx.y) * t + row0 + r0;
  const float lse2[2] = {lse[at_row] * kLog2e, lse[at_row + 8] * kLog2e};
  const float ddr[2] = {dd[at_row], dd[at_row + 8]};

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    if (j + 1 < n_tiles) {
      const long long next = static_cast<long long>(j + 1) * kTile * kD;
      load_tile(sK(s ^ 1), kb + next);
      load_tile(sV(s ^ 1), vb + next);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 64 queries x 64 keys each
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, desc_k(sQ, kk), desc_k(sK(s), kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(dp, desc_k(sO, kk), desc_k(sV(s), kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // S is ready; dP may still run
    fence_regs(sc);

    const bool diag = causal && j == qt;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(sc[4 * i + e] * scale_log2 - lse2[e >> 1]);  // LSE +inf -> 0
        if (diag && 8 * i + c0 + (e & 1) > r0 + 8 * (e >> 1)) p = 0.f;  // key > query
        sc[4 * i + e] = p;
      }
    }

    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - ddr[(i >> 1) & 1]);
    uint32_t da[4][4];
    to_a_fragments(dp, da);

    // dQ += dS K, K as the MN-major operand
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, da[kk], desc_mn(sK(s), kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every lane is done with stage s before it is refilled
  }

  store_acc(dq + off + row0 * kD, acc, scale, scale);
}

int run_checks(int bh, int t, int d, int bf16_in) {
  if (bh <= 0 || t <= 0) return -1;  // nothing to do
  if (!bf16_in || d != kD || t % kTile != 0 || bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// All tensors (B*H, T, 64) bf16, contiguous, 16-byte aligned; lse and dd
// (B*H, T) f32; T a multiple of 64. The caller checks this; anything else
// returns cudaErrorInvalidValue without a launch.
extern "C" int mpit_flash_forward_sm90(const void* q, const void* k, const void* v,
                                       void* o, void* lse, int bh, int t, int d,
                                       int causal, int bf16_in, void* stream) {
  const int c = run_checks(bh, t, d, bf16_in);
  if (c != 0) return c < 0 ? 0 : c;
  const dim3 grid(t / kTile, bh);
  flash_fwd_wgmma_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), t, causal != 0,
      kLog2e / sqrtf(static_cast<float>(d)));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mpit_flash_dkv_sm90(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* dd,
                                   void* dko, void* dvo, int bh, int t, int d,
                                   int causal, int bf16_in, void* stream) {
  const int c = run_checks(bh, t, d, bf16_in);
  if (c != 0) return c < 0 ? 0 : c;
  // above the 48 KB a block gets without asking; set once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float scale = 1.f / sqrtf(static_cast<float>(d));
  const dim3 grid(t / kTile, bh);
  flash_dkv_wgmma_kernel<<<grid, kThreads, kDkvSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dko), static_cast<bf16*>(dvo), t,
      causal != 0, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mpit_flash_dq_sm90(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* dd,
                                  void* dqo, int bh, int t, int d, int causal, int bf16_in,
                                  void* stream) {
  const int c = run_checks(bh, t, d, bf16_in);
  if (c != 0) return c < 0 ? 0 : c;
  // above the 48 KB a block gets without asking; set once per process
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const float scale = 1.f / sqrtf(static_cast<float>(d));
  const dim3 grid(t / kTile, bh);
  flash_dq_wgmma_kernel<<<grid, kThreads, kDqSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dqo), t, causal != 0, scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
