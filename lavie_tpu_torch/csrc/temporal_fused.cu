// Frame-axis attention with half-split partial RoPE and an additive
// relative-position bias, for the temporal attention of every transformer
// block of the video UNet.
//
// Replaces: lavie_tpu/kernels/temporal_fused.py, temporal_attention_cmajor
// (Pallas body _kernel_v5; _kernel_v4 and _kernel are older bodies of the
// same function).
//
// What it computes, per batch b, spatial position s and head h, on the F x d
// slices q[b, :, s, h*d:(h+1)*d] (k, v likewise):
//   q, k <- RoPE over the first rope_dim channels, half-split pairs
//           (c, c + rope_dim/2), computed in bf16 like the plain version;
//   scores[i][j] = fp32 dot(q_i, k_j) * scale + bias[h][i][j];
//   p = exact max-subtracted softmax over j, in fp32;
//   out[i] = sum_j p[i][j] * v_j, accumulated in fp32, stored as bf16.
// Layout: q, k, v, out are (B, F, S, C) with C = H*d and heads contiguous in
// C, i.e. exactly what the surrounding nn.Linear projections read and write,
// so no transpose runs on either side of the kernel.
//
// What bounds it on the H100: device-memory bytes. Each call reads q, k, v
// and writes out once (4 * B*F*S*C*2 bytes; 210 MB at the base L0 level, a
// 63 us floor at 3.35 TB/s), while the arithmetic (4*F*F*d flops per
// position and head) is ~1.7 GFLOP, far below the fp32 rate.
//
// What the design does about it: one thread block per (b, tile of positions,
// h) stages the tile's q, k, v once in shared memory with 16-byte loads, does
// RoPE there, and computes every score, the softmax and probs*v from shared
// memory and registers; the output is staged back in the q buffer and written
// with 16-byte stores. Nothing but q, k, v and out touches device memory (the
// (H, F, F) bias and the (F, rope_dim/2) tables are a few KB and stay in
// cache). One thread owns one query row: its F scores live in registers
// (FMAX is a template bound, 16/32/64). Shared rows are padded so that eight
// consecutive threads' 16-byte reads fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    float2 p = __bfloat1622float2(h[t]);
    f[2 * t] = p.x;
    f[2 * t + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(f[2 * t], f[2 * t + 1]);
  return u;
}

template <int FMAX>
__global__ void temporal_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    const float* __restrict__ bias, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, int F, int S, int H, int d, int ds,
    int rope_half, int tile_s, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [tile_s*F][ds]
  __nv_bfloat16* ks = qs + (size_t)tile_s * F * ds;
  __nv_bfloat16* vs = ks + (size_t)tile_s * F * ds;

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * tile_s;
  const int C = H * d;
  const int nvec = d / 8;  // 16-byte chunks per row
  const int rows = tile_s * F;  // row = p*F + f

  // 1. stage q, k, v for this tile (zero rows past the end of S)
  for (int idx = threadIdx.x; idx < rows * nvec; idx += blockDim.x) {
    const int row = idx / nvec, c8 = idx - row * nvec;
    const int p = row / F, f = row - p * F, s = s0 + p;
    uint4 zq = make_uint4(0, 0, 0, 0), zk = zq, zv = zq;
    if (s < S) {
      const size_t off = (((size_t)b * F + f) * S + s) * C + (size_t)h * d + c8 * 8;
      zq = *reinterpret_cast<const uint4*>(q + off);
      zk = *reinterpret_cast<const uint4*>(k + off);
      zv = *reinterpret_cast<const uint4*>(v + off);
    }
    const int so = row * ds + c8 * 8;
    *reinterpret_cast<uint4*>(qs + so) = zq;
    *reinterpret_cast<uint4*>(ks + so) = zk;
    *reinterpret_cast<uint4*>(vs + so) = zv;
  }
  __syncthreads();

  // 2. RoPE in place, rounding to bf16 after every operation as the plain
  //    version's bf16 elementwise ops do
  if (rope_half > 0) {
    for (int idx = threadIdx.x; idx < rows * rope_half; idx += blockDim.x) {
      const int row = idx / rope_half, c = idx - row * rope_half;
      const int f = row % F;
      const float cs = bf16_round(cos_t[f * rope_half + c]);
      const float sn = bf16_round(sin_t[f * rope_half + c]);
      __nv_bfloat16* xs[2] = {qs, ks};
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        __nv_bfloat16* r = xs[t] + row * ds;
        const float a = __bfloat162float(r[c]);
        const float bb = __bfloat162float(r[c + rope_half]);
        const float ra = bf16_round(bf16_round(a * cs) - bf16_round(bb * sn));
        const float rb = bf16_round(bf16_round(bb * cs) + bf16_round(a * sn));
        r[c] = __float2bfloat16(ra);
        r[c + rope_half] = __float2bfloat16(rb);
      }
    }
    __syncthreads();
  }

  // 3. one thread per query row: scores, softmax, probs*v
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    const int p = row / F, i = row - p * F;
    if (s0 + p >= S) continue;
    __nv_bfloat16* qrow = qs + row * ds;
    const __nv_bfloat16* kb = ks + p * F * ds;
    const __nv_bfloat16* vb = vs + p * F * ds;

    float sc[FMAX];
#pragma unroll
    for (int j = 0; j < FMAX; ++j) sc[j] = 0.f;
    for (int c8 = 0; c8 < nvec; ++c8) {
      float qf[8];
      unpack8(*reinterpret_cast<const uint4*>(qrow + c8 * 8), qf);
#pragma unroll
      for (int j = 0; j < FMAX; ++j) {
        if (j < F) {
          float kf[8];
          unpack8(*reinterpret_cast<const uint4*>(kb + j * ds + c8 * 8), kf);
          float acc = sc[j];
#pragma unroll
          for (int t = 0; t < 8; ++t) acc = fmaf(qf[t], kf[t], acc);
          sc[j] = acc;
        }
      }
    }
    float m = -INFINITY;
    const float* brow = bias ? bias + ((size_t)h * F + i) * F : nullptr;
#pragma unroll
    for (int j = 0; j < FMAX; ++j) {
      if (j < F) {
        sc[j] = sc[j] * scale + (brow ? brow[j] : 0.f);
        m = fmaxf(m, sc[j]);
      }
    }
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < FMAX; ++j) {
      if (j < F) {
        sc[j] = expf(sc[j] - m);
        den += sc[j];
      }
    }
    const float inv = 1.f / den;
    // the output row overwrites this thread's own q row, which no other
    // thread reads
    for (int c8 = 0; c8 < nvec; ++c8) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < FMAX; ++j) {
        if (j < F) {
          float vf[8];
          unpack8(*reinterpret_cast<const uint4*>(vb + j * ds + c8 * 8), vf);
          const float pj = sc[j] * inv;
#pragma unroll
          for (int t = 0; t < 8; ++t) acc[t] = fmaf(pj, vf[t], acc[t]);
        }
      }
      *reinterpret_cast<uint4*>(qrow + c8 * 8) = pack8(acc);
    }
  }
  __syncthreads();

  // 4. write the tile back
  for (int idx = threadIdx.x; idx < rows * nvec; idx += blockDim.x) {
    const int row = idx / nvec, c8 = idx - row * nvec;
    const int p = row / F, f = row - p * F, s = s0 + p;
    if (s < S) {
      const size_t off = (((size_t)b * F + f) * S + s) * C + (size_t)h * d + c8 * 8;
      *reinterpret_cast<uint4*>(out + off) =
          *reinterpret_cast<const uint4*>(qs + row * ds + c8 * 8);
    }
  }
}

template <int FMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const float* bias, const float* cos_t, const float* sin_t,
                   int B, int F, int S, int H, int d, int rope_half, float scale,
                   cudaStream_t stream) {
  // pad rows to an odd number of 16-byte chunks: conflict-free 16-byte reads
  const int ds = ((d / 8) % 2 == 1) ? d : d + 8;
  const int bytes_per_pos = 3 * F * ds * 2;
  int tile_s = 128 / F;
  if (tile_s < 1) tile_s = 1;
  while (tile_s > 1 && tile_s * bytes_per_pos > 64 * 1024) --tile_s;
  const size_t smem = (size_t)tile_s * bytes_per_pos;
  int threads = ((tile_s * F + 31) / 32) * 32;
  if (threads > 128) threads = 128;
  cudaError_t err = cudaFuncSetAttribute(
      temporal_attention_kernel<FMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + tile_s - 1) / tile_s, H, B);
  temporal_attention_kernel<FMAX><<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), bias,
      cos_t, sin_t, F, S, H, d, ds, rope_half, tile_s, scale);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, F, S, H*d) bf16, contiguous. bias: (H, F, F) fp32 or
// NULL. cos_t, sin_t: (F, rope_half) fp32 (ignored when rope_half == 0).
// Requires d % 8 == 0, 2*rope_half <= d, F <= 64. Returns cudaGetLastError().
extern "C" int temporal_attention_bf16(
    const void* q, const void* k, const void* v, void* out, const float* bias,
    const float* cos_t, const float* sin_t, int B, int F, int S, int H, int d,
    int rope_half, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 8 != 0 || 2 * rope_half > d || F < 1 || F > 64) return (int)cudaErrorInvalidValue;
  if (F <= 16) return (int)launch<16>(q, k, v, out, bias, cos_t, sin_t, B, F, S, H, d, rope_half, scale, st);
  if (F <= 32) return (int)launch<32>(q, k, v, out, bias, cos_t, sin_t, B, F, S, H, d, rope_half, scale, st);
  return (int)launch<64>(q, k, v, out, bias, cos_t, sin_t, B, F, S, H, d, rope_half, scale, st);
}
