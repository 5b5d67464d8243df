// Fused GEGLU feed-forward of the transformer blocks:
//   y = (x W0h^T + b0h) * gelu_erf(x W0g^T + b0g) W2^T + b2
// with x (N, C), W0 = [W0h; W0g] (2I, C), W2 (C, I), I = 4C (nn.Linear
// weight layouts, bf16), fp32 accumulation on both products.
//
// Replaces: lavie_tpu/kernels/geglu.py, geglu (Pallas body _geglu_kernel).
//
// What bounds it on the H100: tensor-core operations. One base level is
// 6*N*C*I = 201 GFLOP (N = 81920, C = 320), 0.20 ms at 989 TFLOP/s dense
// bf16, against 2*N*C*2 bytes of activations (105 MB, 31 us at 3.35 TB/s).
// The unfused form would also write and read back the (N, 2I) fp32 hidden,
// 8x the activation bytes.
//
// What the design does about it: the (N, I) hidden never reaches device
// memory. A block owns BM rows of x and the whole (BM, C) output; the output
// accumulators stay in registers (wmma fp32 fragments, eight 16x16 tiles per
// warp) for the block's lifetime, so the first product is computed once,
// never once per output-column tile. The block walks I in 16 chunks of BI
// columns: the hidden and gate chunks (tensor cores, x from shared memory)
// go to shared memory in fp32, the gelu gate turns them into a bf16 (BM, BI)
// act tile, and act * W2[:, chunk]^T accumulates into the registers.
// BM = 2048*NW/C rows with NW = 10 warps: 64 at C = 320, 32 at 640, 16 at
// 1280, so the output tile is always 80 fragments. The TPU version kept W0 and W2 resident
// in VMEM; here they are 2.5 MB (C = 320) to 39 MB (C = 1280) and cannot sit
// in a block's 227 KB, so each warp reads its weight fragments straight from
// device memory, where the 50 MB L2 serves the repeats across blocks. This
// is the simple version: no TMA, no wgmma, no software pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int CHUNKS = 16;  // I / BI

// R: 16-row tiles per block (BM = 16R); CT: 16-column output tiles per warp;
// NW: warps. C = 16*CT*NW, R*CT = 8, BI = 4*NW*CT.
template <int R, int CT, int NW>
__global__ void __launch_bounds__(NW * 32)
geglu_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w0,
             const __nv_bfloat16* __restrict__ b0, const __nv_bfloat16* __restrict__ w2,
             const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ y, int N) {
  constexpr int BM = 16 * R;
  constexpr int C = 16 * CT * NW;
  constexpr int I = 4 * C;
  constexpr int BI = I / CHUNKS;
  constexpr int XLD = C + 16;   // bf16 x tile row stride
  constexpr int HLD = BI + 4;   // fp32 hidden/gate row stride
  constexpr int ALD = BI + 16;  // bf16 act row stride
  constexpr int OLD = C + 4;    // fp32 output staging row stride
  constexpr int PAIRS = R * (BI / 16) / NW;  // (hidden, gate) fragment pairs per warp

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);                 // [BM][XLD]
  float* hs = reinterpret_cast<float*>(xs + BM * XLD);                        // [BM][HLD]
  float* gs = hs + BM * HLD;                                                   // [BM][HLD]
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(gs + BM * HLD);        // [BM][ALD]
  float* os = reinterpret_cast<float*>(smem);                                  // [BM][OLD], after the loop

  const int warp = threadIdx.x / 32;
  const int row0 = blockIdx.x * BM;

  // x tile, zero rows past N
  for (int idx = threadIdx.x; idx < BM * (C / 8); idx += NW * 32) {
    const int r = idx / (C / 8), c8 = idx - r * (C / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < N) val = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * C + c8 * 8);
    *reinterpret_cast<uint4*>(xs + r * XLD + c8 * 8) = val;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[R][CT];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) wmma::fill_fragment(acc[r][ct], 0.f);

  for (int chunk = 0; chunk < CHUNKS; ++chunk) {
    const int i0 = chunk * BI;

    // hidden and gate chunks: (BM, BI) each, over K = C
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[PAIRS], gacc[PAIRS];
#pragma unroll
      for (int pp = 0; pp < PAIRS; ++pp) {
        wmma::fill_fragment(hacc[pp], 0.f);
        wmma::fill_fragment(gacc[pp], 0.f);
      }
      for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
        for (int pp = 0; pp < PAIRS; ++pp) {
          const int pair = warp * PAIRS + pp;
          const int r = pair / (BI / 16), j = pair - r * (BI / 16);
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bh, bg;
          wmma::load_matrix_sync(a, xs + r * 16 * XLD + kk * 16, XLD);
          wmma::load_matrix_sync(bh, w0 + (size_t)(i0 + j * 16) * C + kk * 16, C);
          wmma::load_matrix_sync(bg, w0 + (size_t)(I + i0 + j * 16) * C + kk * 16, C);
          wmma::mma_sync(hacc[pp], a, bh, hacc[pp]);
          wmma::mma_sync(gacc[pp], a, bg, gacc[pp]);
        }
      }
#pragma unroll
      for (int pp = 0; pp < PAIRS; ++pp) {
        const int pair = warp * PAIRS + pp;
        const int r = pair / (BI / 16), j = pair - r * (BI / 16);
        wmma::store_matrix_sync(hs + r * 16 * HLD + j * 16, hacc[pp], HLD, wmma::mem_row_major);
        wmma::store_matrix_sync(gs + r * 16 * HLD + j * 16, gacc[pp], HLD, wmma::mem_row_major);
      }
    }
    __syncthreads();

    // act = (hidden + b0h) * gelu_erf(gate + b0g), rounded to bf16
    for (int idx = threadIdx.x; idx < BM * BI; idx += NW * 32) {
      const int r = idx / BI, c = idx - r * BI;
      const float hv = hs[r * HLD + c] + __bfloat162float(b0[i0 + c]);
      const float gv = gs[r * HLD + c] + __bfloat162float(b0[I + i0 + c]);
      const float gelu = 0.5f * gv * (1.f + erff(gv * 0.70710678118654752f));
      as[r * ALD + c] = __float2bfloat16(hv * gelu);
    }
    __syncthreads();

    // acc += act (BM, BI) * W2[:, i0:i0+BI]^T
#pragma unroll
    for (int kk = 0; kk < BI / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[R];
#pragma unroll
      for (int r = 0; r < R; ++r) wmma::load_matrix_sync(a[r], as + r * 16 * ALD + kk * 16, ALD);
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) {
        const int n0 = (warp * CT + ct) * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bw;
        wmma::load_matrix_sync(bw, w2 + (size_t)n0 * I + i0 + kk * 16, I);
#pragma unroll
        for (int r = 0; r < R; ++r) wmma::mma_sync(acc[r][ct], a[r], bw, acc[r][ct]);
      }
    }
    // the next chunk's first barrier orders these act reads before the
    // next act writes
  }
  __syncthreads();  // the output staging overwrites the x tile

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct)
      wmma::store_matrix_sync(os + r * 16 * OLD + (warp * CT + ct) * 16, acc[r][ct], OLD,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * (C / 2); idx += NW * 32) {
    const int r = idx / (C / 2), c = (idx - r * (C / 2)) * 2;
    if (row0 + r < N) {
      const float v0 = os[r * OLD + c] + __bfloat162float(b2[c]);
      const float v1 = os[r * OLD + c + 1] + __bfloat162float(b2[c + 1]);
      *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(row0 + r) * C + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

template <int R, int CT, int NW>
cudaError_t launch(const void* x, const void* w0, const void* b0, const void* w2,
                   const void* b2, void* y, int N, cudaStream_t stream) {
  constexpr int BM = 16 * R, C = 16 * CT * NW, BI = 4 * C / CHUNKS;
  const size_t loop_bytes = (size_t)BM * (C + 16) * 2 + 2 * (size_t)BM * (BI + 4) * 4 +
                            (size_t)BM * (BI + 16) * 2;
  const size_t out_bytes = (size_t)BM * (C + 4) * 4;
  const size_t smem = loop_bytes > out_bytes ? loop_bytes : out_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      geglu_kernel<R, CT, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  geglu_kernel<R, CT, NW><<<(N + BM - 1) / BM, NW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(b0), static_cast<const __nv_bfloat16*>(w2),
      static_cast<const __nv_bfloat16*>(b2), static_cast<__nv_bfloat16*>(y), N);
  return cudaGetLastError();
}

}  // namespace

// x (N, C), w0 (2I, C), b0 (2I), w2 (C, I), b2 (C), y (N, C): bf16,
// contiguous, 32-byte aligned, I = 4C. C must be one of 128, 256, 320, 512,
// 640, 1024, 1280. Returns cudaGetLastError().
extern "C" int geglu_bf16(const void* x, const void* w0, const void* b0, const void* w2,
                          const void* b2, void* y, int N, int C, int I, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (I != 4 * C || N < 1) return (int)cudaErrorInvalidValue;
  switch (C) {
    case 128: return (int)launch<8, 1, 8>(x, w0, b0, w2, b2, y, N, st);
    case 256: return (int)launch<4, 2, 8>(x, w0, b0, w2, b2, y, N, st);
    case 320: return (int)launch<4, 2, 10>(x, w0, b0, w2, b2, y, N, st);
    case 512: return (int)launch<2, 4, 8>(x, w0, b0, w2, b2, y, N, st);
    case 640: return (int)launch<2, 4, 10>(x, w0, b0, w2, b2, y, N, st);
    case 1024: return (int)launch<1, 8, 8>(x, w0, b0, w2, b2, y, N, st);
    case 1280: return (int)launch<1, 8, 10>(x, w0, b0, w2, b2, y, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
