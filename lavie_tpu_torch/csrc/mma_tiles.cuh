// The TPU kernels' LayerNorm (fp32 statistics, elementwise steps rounded to
// bf16 one by one) and the LayerNorm pass over a row-major (N, C) tensor
// that the LayerNorm kernels of cross_block.cu, cross_head.cu,
// temporal_proj.cu and transformer_tail.cu run, each block THREADS = 256
// threads (8 warps); and the bf16 mma.sync m16n8k16 tile that
// cross_attention.cu's long-kv kernel runs on.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

typedef __nv_bfloat16 bf16;
constexpr int THREADS = 256;  // 8 warps

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

}  // namespace tiles
