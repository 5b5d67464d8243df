// Frame-axis attention with half-split partial RoPE and an additive
// relative-position bias, for the temporal attention of every transformer
// block of the video UNet.
//
// Replaces: lavie_tpu/kernels/temporal_fused.py, temporal_attention_cmajor
// (Pallas body _kernel_v5; _kernel_v4 and _kernel are older bodies of the
// same function); and lavie_tpu/kernels/temporal_attention.py,
// temporal_attention (_temporal_bfcs, body _temporal_kernel), the opt-in
// "folded" route: the same function on q and k rotated by the caller, which
// is this kernel with rope_half = 0 and a bias.
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
// and writes out once (4 * B*F*S*C*2 bytes; 200 MB at the TSR F=61 levels,
// a 60 us floor at 3.35 TB/s), while the products (4*F*F*d flops per
// position and head) are a few GFLOP even padded to the tensor-core tiles.
//
// What the design does about it:
// - Persistent blocks walk tiles of (batch, T positions, head), heads
//   innermost so that neighbouring blocks read neighbouring bytes. Each tile's
//   q, k, v go to shared memory by cp.async into a ring of `stages` tiles,
//   so the next tiles' loads are in flight while one is computed. Rows are
//   padded to an odd number of 16-byte chunks (conflict-free ldmatrix at
//   every d), and padding rows and columns are zeroed once and never written.
// - The frames of a position are padded to FR rows: 8 for F <= 8 (two
//   positions share one 16-row tile, with a block-diagonal mask), else a
//   multiple of 16 (ceil(F/16) tiles of 16 query rows). One warp owns one
//   16-row tile at a time.
// - QK^T runs on mma.sync m16n8k16 bf16 with fp32 accumulation, fragments
//   by ldmatrix; the scores never leave the accumulator registers. The bias
//   is added in fp32 before the max; padded keys get -inf.
// - P.V keeps P in fp32 precision: p = hi + lo with hi = bf16(p) and
//   lo = bf16(p - hi), two m16n8k16 products into one fp32 accumulator
//   (exact products; the error is about 2^-17 of p), as the plain version
//   multiplies fp32 probabilities by v. V comes through ldmatrix.trans.
// - RoPE runs in shared memory between a tile's arrival and its first
//   ldmatrix, rounding to bf16 after every operation as the plain version.
// - The output goes back through the warp's own q rows in shared memory
//   and out with 16-byte stores.
// The launch plan (T, FR, stages, threads, grid, shared bytes) is computed
// by lavie_tpu_torch/kernels/temporal_fused.py::launch_plan; the entry
// checks it and refuses what it cannot take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_STAGES = 4;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n (the ring's other stages) groups are in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

// not volatile: a pure function of its registers, which the compiler may
// schedule among the ldmatrix loads
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// hi = bf16(x), lo = bf16(x - hi), for the pair (x0, x1)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// x / n for x < 2^16 and 1 <= n < 2^16 by a multiply-high: m = ceil(2^32 / n)
// leaves an error below 2^-16, less than the gap from x/n to the next integer
// (n = 1, whose m does not fit in 32 bits, is stored as m = 0).
// The indices divided here stay below 2^16: a stage holds T*F rows of at
// least 6*d bytes each, so T*F*(d/8) and T*F*rope_half are below 2^15.
struct FastDiv {
  uint32_t n, m;
  __device__ __forceinline__ explicit FastDiv(int d)
      : n((uint32_t)d), m((uint32_t)((0x100000000ull + d - 1) / d)) {}
  __device__ __forceinline__ int div(int x) const {
    return m ? (int)__umulhi((uint32_t)x, m) : x;
  }
};

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  const float* bias;
  const float* cos_t;
  const float* sin_t;
  int F, S, H, d, rope_half;
  float scale;
  int FR, T, stages, tiles_per_seq, tiles;
};

// KT: 16-key chunks a query tile attends over (keys = max(FR, 16)).
template <int KT>
__global__ void __launch_bounds__(MAX_THREADS) temporal_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int F = a.F, S = a.S, H = a.H, d = a.d, FR = a.FR, T = a.T;
  const int ds = (d + 15) / 16 * 16 + 8;  // row stride: an odd number of 16-byte chunks
  const int rows = T * FR;                // rows of one tensor in a stage
  const int stage_elems = 3 * rows * ds;
  const int C = H * d;
  const int nvec = d / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tig = lane & 3;

  // zero the ring once: padding rows and columns are never written again
  for (int i = tid; i < a.stages * stage_elems / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int first = blockIdx.x, step = gridDim.x;
  const int n_local = first < a.tiles ? (a.tiles - 1 - first) / step + 1 : 0;

  const FastDiv by_nvec(nvec), by_T(T), by_rh(a.rope_half > 0 ? a.rope_half : 1);

  auto load_tile = [&](int t, int stage) {
    const int h = t % H, rest = t / H, s0 = (rest % a.tiles_per_seq) * T, b = rest / a.tiles_per_seq;
    __nv_bfloat16* qd = ring + (size_t)stage * stage_elems;
    __nv_bfloat16* kd = qd + rows * ds;
    __nv_bfloat16* vd = kd + rows * ds;
    for (int idx = tid; idx < F * T * nvec; idx += blockDim.x) {
      const int r = by_nvec.div(idx), c8 = idx - r * nvec;
      const int f = by_T.div(r), p = r - f * T, s = s0 + p;
      const bool ok = s < S;
      const size_t off = (((size_t)b * F + f) * S + (ok ? s : 0)) * C + (size_t)h * d + c8 * 8;
      const int so = (p * FR + f) * ds + c8 * 8;
      cp_async16(qd + so, a.q + off, ok);
      cp_async16(kd + so, a.k + off, ok);
      cp_async16(vd + so, a.v + off, ok);
    }
  };

  for (int i = 0; i < a.stages - 1; ++i) {
    if (i < n_local) load_tile(first + i * step, i);
    cp_async_commit();
  }

  const int mtiles = rows / 16;
  const int ksteps = (d + 15) / 16;

  for (int i = 0; i < n_local; ++i) {
    const int stage = i % a.stages;
    {
      const int j = i + a.stages - 1;  // the stage it fills was freed at the end of i-1
      if (j < n_local) load_tile(first + j * step, j % a.stages);
      cp_async_commit();
    }
    cp_async_wait_pending(a.stages - 1);
    __syncthreads();

    const int t = first + i * step;
    const int h = t % H, rest = t / H, s0 = (rest % a.tiles_per_seq) * T, b = rest / a.tiles_per_seq;
    __nv_bfloat16* qs = ring + (size_t)stage * stage_elems;
    __nv_bfloat16* ks = qs + rows * ds;
    const __nv_bfloat16* vs = ks + rows * ds;

    // RoPE in place on one (row, channel pair) of q and k, rounding to bf16
    // after every operation as the plain version's bf16 elementwise ops do
    auto rope = [&](int row, int f, int c) {
      const int rh = a.rope_half;
      const float cs = bf16_round(__ldg(a.cos_t + f * rh + c));
      const float sn = bf16_round(__ldg(a.sin_t + f * rh + c));
      __nv_bfloat16* xs[2] = {qs, ks};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        __nv_bfloat16* rr = xs[u] + row * ds;
        const float x0 = __bfloat162float(rr[c]);
        const float x1 = __bfloat162float(rr[c + rh]);
        const float r0 = bf16_round(bf16_round(x0 * cs) - bf16_round(x1 * sn));
        const float r1 = bf16_round(bf16_round(x1 * cs) + bf16_round(x0 * sn));
        rr[c] = __float2bfloat16(r0);
        rr[c + rh] = __float2bfloat16(r1);
      }
    };
    // a 16-row tile owns its key rows when a position takes at most 16 rows:
    // then each warp rotates its own rows; else the block does, first
    const bool rope_by_warp = a.rope_half > 0 && FR <= 16;
    if (a.rope_half > 0 && !rope_by_warp) {
      for (int idx = tid; idx < T * F * a.rope_half; idx += blockDim.x) {
        const int r = by_rh.div(idx), c = idx - r * a.rope_half;
        const int f = by_T.div(r), p = r - f * T;
        rope(p * FR + f, f, c);
      }
      __syncthreads();
    }

    for (int mt = warp; mt < mtiles; mt += nwarps) {
      const int row0 = mt * 16;
      const int kr0 = FR == 8 ? row0 : row0 / FR * FR;  // first key row of the tile's position(s)
      const int qf0 = FR == 8 ? 0 : row0 % FR;          // frame of the tile's row 0
      if (rope_by_warp) {
        for (int idx = lane; idx < 16 * a.rope_half; idx += 32) {
          const int r = by_rh.div(idx), c = idx - r * a.rope_half;
          const int f = (row0 + r) & (FR - 1);  // FR is 8 or 16 here
          if (f < F) rope(row0 + r, f, c);
        }
        __syncwarp();
      }

      // scores: 16 query rows x 16*KT keys
      float sc[2 * KT][4];
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t af[4];
        ldsm_x4(af[0], af[1], af[2], af[3], qs + (row0 + (lane & 15)) * ds + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(b0, b1, b2, b3,
                  ks + (kr0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * ds + kk * 16 +
                      ((lane >> 3) & 1) * 8);
          mma16816(sc[2 * np], af, b0, b1);
          mma16816(sc[2 * np + 1], af, b2, b3);
        }
      }

      // exact softmax over each row's valid keys, in fp32
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, col = n * 8 + tig * 2 + (e & 1);
          const int kf = FR == 8 ? (col & 7) : col;
          const bool valid = kf < F && (FR != 8 || (col >> 3) == hr);
          const int qf = FR == 8 ? g : qf0 + g + 8 * hr;
          float x = -INFINITY;
          if (valid) {
            x = sc[n][e] * a.scale;
            if (a.bias != nullptr && qf < F) x += __ldg(a.bias + ((size_t)h * F + qf) * F + kf);
          }
          sc[n][e] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      }
      float den[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      }
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(sc[n][e] - mx[e >> 1]);
          sc[n][e] = x;
          den[e >> 1] += x;
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        den[hr] += __shfl_xor_sync(0xffffffffu, den[hr], 1);
        den[hr] += __shfl_xor_sync(0xffffffffu, den[hr], 2);
      }
      const float inv0 = 1.f / den[0], inv1 = 1.f / den[1];

      // P as the A operand of KT k16 steps, split into bf16 hi + lo
      uint32_t phi[KT][4], plo[KT][4];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        split_bf16(sc[2 * j][0] * inv0, sc[2 * j][1] * inv0, phi[j][0], plo[j][0]);
        split_bf16(sc[2 * j][2] * inv1, sc[2 * j][3] * inv1, phi[j][1], plo[j][1]);
        split_bf16(sc[2 * j + 1][0] * inv0, sc[2 * j + 1][1] * inv0, phi[j][2], plo[j][2]);
        split_bf16(sc[2 * j + 1][2] * inv1, sc[2 * j + 1][3] * inv1, phi[j][3], plo[j][3]);
      }

      // O = P V in chunks of 64 columns, each staged into the warp's own q
      // rows (no other warp reads them) once every lane is done reading them
      __syncwarp();
      __nv_bfloat16* orow = qs + row0 * ds;
      for (int c0 = 0; c0 < d; c0 += 64) {
        const int nt = min(8, (d - c0) / 8);
        float o[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
        for (int j = 0; j < KT; ++j) {
          uint32_t bv[4][4];
#pragma unroll
          for (int np = 0; np < 4; ++np)
            if (2 * np < nt)
              ldsm_x4_t(bv[np][0], bv[np][1], bv[np][2], bv[np][3],
                        vs + (kr0 + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ds + c0 +
                            np * 16 + (lane >> 4) * 8);
          // the hi products of every column, then the lo ones: eight
          // independent accumulators between two updates of one
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (2 * np < nt) mma16816(o[2 * np], phi[j], bv[np][0], bv[np][1]);
            if (2 * np + 1 < nt) mma16816(o[2 * np + 1], phi[j], bv[np][2], bv[np][3]);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (2 * np < nt) mma16816(o[2 * np], plo[j], bv[np][0], bv[np][1]);
            if (2 * np + 1 < nt) mma16816(o[2 * np + 1], plo[j], bv[np][2], bv[np][3]);
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n < nt) {
            const int col = c0 + n * 8 + tig * 2;
            *reinterpret_cast<__nv_bfloat162*>(orow + g * ds + col) =
                __floats2bfloat162_rn(o[n][0], o[n][1]);
            *reinterpret_cast<__nv_bfloat162*>(orow + (g + 8) * ds + col) =
                __floats2bfloat162_rn(o[n][2], o[n][3]);
          }
        }
        __syncwarp();
        // 16-byte stores of the chunk's columns in the tile's valid rows
        for (int idx = lane; idx < 16 * 8; idx += 32) {
          const int r = idx >> 3, c8 = idx & 7;
          const int row = row0 + r, p = row / FR, f = row - p * FR, s = s0 + p;
          if (c8 < nt && f < F && s < S) {
            const size_t off = (((size_t)b * F + f) * S + s) * C + (size_t)h * d + c0 + c8 * 8;
            *reinterpret_cast<uint4*>(a.out + off) =
                *reinterpret_cast<const uint4*>(orow + r * ds + c0 + c8 * 8);
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();  // the stage is refilled by a later iteration's load
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

template <int KT>
cudaError_t launch(const Args& a, int threads, int grid, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(temporal_attention_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  temporal_attention_kernel<KT><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, out: (B, F, S, H*d) bf16, contiguous. bias: (H, F, F) fp32 or
// NULL. cos_t, sin_t: (F, rope_half) fp32 (ignored when rope_half == 0).
// Requires d % 8 == 0, 2*rope_half <= d, F <= 64. The launch plan: tile_s
// positions per tile (even when frames_pad == 8), frames_pad = 8 for F <= 8
// else F rounded up to 16, stages (1-4) tiles in the ring, threads (a
// multiple of 32, at most 256), grid persistent blocks, smem_bytes =
// stages * tile_s * 3 * frames_pad * (d rounded up to 16, + 8) * 2. Returns
// cudaErrorInvalidValue for a plan it cannot take, else cudaGetLastError().
extern "C" int temporal_attention_bf16(
    const void* q, const void* k, const void* v, void* out, const float* bias,
    const float* cos_t, const float* sin_t, int B, int F, int S, int H, int d,
    int rope_half, float scale, int tile_s, int frames_pad, int stages, int threads, int grid,
    int smem_bytes, void* stream) {
  if (d < 8 || d % 8 != 0 || 2 * rope_half > d || F < 1 || F > 64 || B < 1 || S < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const int fr = F <= 8 ? 8 : (F + 15) / 16 * 16;
  const long long ds = (d + 15) / 16 * 16 + 8;
  if (frames_pad != fr || tile_s < 1 || (fr == 8 && tile_s % 2 != 0)) return (int)cudaErrorInvalidValue;
  if (stages < 1 || stages > MAX_STAGES || threads < 32 || threads > MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  if ((long long)stages * tile_s * 3 * fr * ds * 2 != smem_bytes) return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem_bytes > smem_max) return (int)cudaErrorInvalidValue;
  const long long per_seq = (S + tile_s - 1) / tile_s;
  const long long tiles = per_seq * H * B;
  if (tiles > 0x7fffffffLL || grid < 1 || grid > tiles) return (int)cudaErrorInvalidValue;

  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), bias, cos_t, sin_t,
         F, S, H, d, rope_half, scale, fr, tile_s, stages, (int)per_seq, (int)tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int keys = fr < 16 ? 16 : fr;
  switch (keys / 16) {
    case 1: return (int)launch<1>(a, threads, grid, smem_bytes, st);
    case 2: return (int)launch<2>(a, threads, grid, smem_bytes, st);
    case 3: return (int)launch<3>(a, threads, grid, smem_bytes, st);
    default: return (int)launch<4>(a, threads, grid, smem_bytes, st);
  }
}
