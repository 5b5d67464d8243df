// Building blocks shared by the token-tile kernels (cross_block.cu,
// temporal_proj.cu): cp.async and ldmatrix wrappers, the bf16 mma.sync
// m16n8k16 tile, a (ROWS, K) x (K, NCOLS) product whose weights stream
// through a double-buffered cp.async ring, and the TPU kernels' LayerNorm
// (fp32 statistics, elementwise steps rounded to bf16 one by one), and the
// LayerNorm pass over a row-major (N, C) tensor that transformer_tail.cu's
// and cross_head.cu's LayerNorm kernels run.
// Every block that uses them has THREADS = 256 threads (8 warps).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

typedef __nv_bfloat16 bf16;
constexpr int THREADS = 256;  // 8 warps
constexpr int WLD = 24;       // weight-stage row stride: 16 channels + 8 pad

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 lanes at a time, each step rounded to bf16 on its own. The
// named rounding (.rn) keeps ptxas from contracting a mul and an add into
// one fma, whose single rounding differs from the TPU kernels' two.
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// acc += A (ROWS x K, shared, row stride lda) * W^T over NCOLS output
// columns, where output column c reads the K contiguous weights at wrow(c).
// Warp w owns columns [w*NCOLS/8, (w+1)*NCOLS/8) for all ROWS rows; its
// accumulator element (mt, nt, e) is row mt*16 + g + (e/2)*8, column
// w*NCOLS/8 + nt*8 + tig*2 + e%2. All 256 threads call it; it begins and
// ends with a barrier-ordered ring, so A may have been written just before.
template <int ROWS, int NCOLS, int K, typename RowFn>
__device__ __forceinline__ void gemm(float (&acc)[ROWS / 16][NCOLS / 64][4], const bf16* A,
                                     int lda, RowFn wrow, bf16* ring) {
  constexpr int MT = ROWS / 16, NT = NCOLS / 64, KS = K / 16;
  static_assert(NT % 2 == 0, "pairs of n8 tiles");
  static_assert(K % 16 == 0, "16-channel k-steps");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto load = [&](int s, int st) {
    for (int idx = tid; idx < NCOLS * 2; idx += THREADS) {
      const int c = idx >> 1, h = idx & 1;
      cp_async16(ring + (st * NCOLS + c) * WLD + h * 8, wrow(c) + s * 16 + h * 8);
    }
  };
  load(0, 0);
  cp_async_commit();
  for (int s = 0; s < KS; ++s) {
    if (s + 1 < KS) {
      load(s + 1, (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wt = ring + (s & 1) * NCOLS * WLD;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], A + (mt * 16 + (lane & 15)) * lda + s * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, wt + (warp * (NCOLS / 8) + np * 16 + (lane & 7) + (lane >> 4) * 8) * WLD +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
    __syncthreads();
  }
}

template <int ROWS, int NCOLS>
__device__ __forceinline__ void zero(float (&acc)[ROWS / 16][NCOLS / 64][4]) {
#pragma unroll
  for (int mt = 0; mt < ROWS / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < NCOLS / 64; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// Visit each accumulator element as fn(row, col, value) with the pairs of
// adjacent columns together: fn(row, col, v0, v1).
template <int ROWS, int NCOLS, typename Fn>
__device__ __forceinline__ void each_pair(const float (&acc)[ROWS / 16][NCOLS / 64][4], Fn fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < ROWS / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < NCOLS / 64; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        fn(mt * 16 + g + hr * 8, warp * (NCOLS / 8) + nt * 8 + tig * 2, acc[mt][nt][2 * hr],
           acc[mt][nt][2 * hr + 1]);
}

// LayerNorm of ROWS rows of C (even) in shared memory, src == dst allowed:
// fp32 mean and E[x^2], then (x - bf16(mean)) * bf16(inv) * bf16(gamma) +
// bf16(beta), each step rounded to bf16. With `stats`, row r's fp32 (mean,
// inv) goes to stats[r].
template <int ROWS, int C>
__device__ __forceinline__ void layer_norm(const bf16* src, bf16* dst, int ld, const float* gamma,
                                           const float* beta, float eps,
                                           float2* stats = nullptr) {
  static_assert(C % 2 == 0, "channel pairs");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * 2; c < C; c += 64) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + r * ld + c));
      s1 += v.x + v.y;
      s2 += v.x * v.x + v.y * v.y;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s1 / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + eps);
    const uint32_t mb = pack_bf16(mean, mean), ib = pack_bf16(inv, inv);
    for (int c = lane * 2; c < C; c += 64) {
      const uint32_t xn = mul_bf16x2(sub_bf16x2(ld32(src + r * ld + c), mb), ib);
      const uint32_t y = add_bf16x2(mul_bf16x2(xn, pack_bf16(gamma[c], gamma[c + 1])),
                                    pack_bf16(beta[c], beta[c + 1]));
      *reinterpret_cast<uint32_t*>(dst + r * ld + c) = y;
    }
    if (stats != nullptr && lane == 0) stats[r] = make_float2(mean, inv);
  }
}

constexpr int LN_ROWS = THREADS / 32;  // rows a block of the LayerNorm pass, one a warp

// The LayerNorm pass: rows LN_ROWS*blockIdx.x.. of x (N, C) into out, through
// shared memory (rows past N read as zeros and not stored), by layer_norm.
// With `stats`, each row's fp32 (mean, inv) too. Each caller wraps it in a
// __global__ of its own, so that a profile tells the passes apart.
template <int C>
__device__ __forceinline__ void layer_norm_pass(const bf16* __restrict__ x,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta,
                                                bf16* __restrict__ out,
                                                float2* __restrict__ stats, int N, float eps) {
  constexpr int LD = C + 8;
  __shared__ __align__(16) unsigned char raw[LN_ROWS * LD * 2];
  __shared__ float2 st[LN_ROWS];
  bf16* T = reinterpret_cast<bf16*>(raw);
  const int r0 = blockIdx.x * LN_ROWS;
  for (int idx = threadIdx.x; idx < LN_ROWS * C / 8; idx += THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < N) v = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * C + c8 * 8);
    *reinterpret_cast<uint4*>(T + r * LD + c8 * 8) = v;
  }
  __syncthreads();
  layer_norm<LN_ROWS, C>(T, T, LD, gamma, beta, eps, stats != nullptr ? st : nullptr);
  __syncthreads();
  for (int idx = threadIdx.x; idx < LN_ROWS * C / 8; idx += THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    if (r0 + r < N)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * C + c8 * 8) =
          *reinterpret_cast<const uint4*>(T + r * LD + c8 * 8);
  }
  if (stats != nullptr && threadIdx.x < LN_ROWS && r0 + threadIdx.x < N)
    stats[r0 + threadIdx.x] = st[threadIdx.x];
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace tiles
