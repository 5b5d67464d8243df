// Flash attention over (rows, S, H*d) bf16 tensors with heads contiguous in
// the channel axis: the sparse-causal attention of the interpolation UNet
// (each frame's keys and values are concat(frame 0, frame i-1) of its video)
// and the same loop over an explicit key/value tensor, for head dims up to
// 160 and for the f4 VAE's single head of 512.
//
// Replaces: lavie_tpu/kernels/flash_attention.py
//   flash_cmajor_sparse (_flash_cmajor_sparse_call, the kv index map
//     kv_index synthesising the concat)       -> flash_sparse_causal_bf16
//   flash_cmajor (_flash_cmajor_call)          -> flash_attention_kv_bf16
// Both Pallas entries run one body, _flash_cmajor_kernel; so do these two.
//   flash_attention (_flash_bhsd, body _flash_kernel) over (B, S, H, d):
//     d <= 160 (the VSR UNet's L3 self-attention, d = 128)
//                                              -> flash_attention_kv_bf16
//     d = 512 (the f4 VAE's mid attention)     -> flash_attention_d512_bf16
//   (the d = 512 kernel is described above its definition below)
//
// What it computes, per query row r, head h and query position i:
//   out[r, i, h] = softmax_j(q[r, i, h] . K_r[j, h] * scale) V_r[j, h]
// sparse: K_r = concat(k[r0], k[rp]) over 2S keys, r0 = r - r % F (frame 0
//   of the video), rp = r - 1, or r itself for frame 0 (whose key set is
//   frame 0 twice, not deduplicated, exactly as the JAX package computes it);
// kv:     K_r = k[r] over Sk keys.
// Scores and the online softmax are fp32; the probabilities go to the
// tensor cores in bf16 (as the TPU body casts p to v's dtype); the output
// accumulates in fp32 and is stored as bf16.
//
// What bounds it on the H100: tensor-core operations at the two large
// interpolation levels (L0: S=2560, d=40, 4*S*2S*d flops per row and head,
// 2.05 TFLOP per call, ~2.1 ms at 989 TFLOP/s; L1 0.26 ms), device-memory
// bytes at the two small ones (each of q, k, v, out moved once). The fp32
// score matrix (51 GB at L0) must never exist: the kernel streams it.
//
// What the design does about it: one block of 4 warps per (query row,
// head, 64 query positions); each warp owns 16 query positions. The loop
// walks the keys in tiles of 64, double-buffered in shared memory with
// cp.async; the tile's source row (r0 for the first S keys, rp for the rest)
// is computed from the tile index inside the block, so the (rows, 2S, C)
// concat is never materialised. QK^T and PV run on mma.sync m16n8k16 bf16
// with fragments from ldmatrix (PV's B operand through ldmatrix.trans); the
// 16x64 score tile stays in registers, is turned into the PV A operand in
// place (the accumulator layout of two n8 tiles is the A layout of one k16
// step), and never touches shared or device memory. Head dims that are not
// multiples of 16 (d=40) are zero-padded in shared memory for the QK^T
// k-steps; PV uses n-steps of 8, which fit any d % 8 == 0. Ragged key tails
// are masked to -inf, ragged query tails are not stored. Shared rows are
// padded by 16 bytes so that ldmatrix's eight row reads hit distinct banks.
// Later work (ROADMAP): wgmma, TMA and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query positions per block
constexpr int BN = 64;        // keys per tile
constexpr int WARPS = 4;      // 16 query positions per warp
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D: head dim (multiple of 8). DP: D rounded up to 16 (QK^T k-steps).
// LDS: shared row stride in elements, DP + 8 (an odd number of 16-byte
// chunks, so ldmatrix's eight rows fall in distinct bank groups).
template <int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq, int Sk,
    int H, int frames, float scale_log2) {
  constexpr int DP = (D + 15) / 16 * 16;
  constexpr int LDS = DP + 8;
  constexpr int KSTEPS = DP / 16;  // QK^T k-steps
  constexpr int NT = D / 8;        // PV n-tiles of 8 channels
  constexpr int NC = D / 8;        // 16-byte chunks per row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LDS]
  __nv_bfloat16* ks = qs + BM * LDS;                               // [2][BN][LDS]
  __nv_bfloat16* vs = ks + 2 * BN * LDS;                           // [2][BN][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int C = H * D;

  // key/value source rows: sparse-causal (frames > 0) walks two halves of
  // Sk keys each, frame 0 of the video then frame i-1; otherwise one half
  // over the row's own keys
  int src0 = r, src1 = r, halves = 1;
  if (frames > 0) {
    const int i = r % frames;
    src0 = r - i;
    src1 = i == 0 ? r : r - 1;
    halves = 2;
  }
  const int tiles_per_half = (Sk + BN - 1) / BN;
  const int ntiles = halves * tiles_per_half;

  // zero the padding columns D..DP-1 once (never written by the loads)
  if (DP > D) {
    for (int row = tid; row < 5 * BM; row += THREADS)
      *reinterpret_cast<uint4*>(qs + row * LDS + D) = make_uint4(0, 0, 0, 0);
  }

  // Q tile, zero rows past Sq
  {
    const __nv_bfloat16* qb = q + ((size_t)r * Sq) * C + (size_t)h * D;
    for (int idx = tid; idx < BM * NC; idx += THREADS) {
      const int row = idx / NC, c8 = idx - row * NC;
      const bool ok = q0 + row < Sq;
      cp_async16(qs + row * LDS + c8 * 8, ok ? qb + (size_t)(q0 + row) * C + c8 * 8 : qb, ok);
    }
  }

  auto load_tile = [&](int t, int stage) {
    const int half = t / tiles_per_half;
    const int k0 = (t - half * tiles_per_half) * BN;
    const size_t base = ((size_t)(half ? src1 : src0) * Sk) * C + (size_t)h * D;
    __nv_bfloat16* kd = ks + stage * BN * LDS;
    __nv_bfloat16* vd = vs + stage * BN * LDS;
    for (int idx = tid; idx < BN * NC; idx += THREADS) {
      const int row = idx / NC, c8 = idx - row * NC;
      const bool ok = k0 + row < Sk;
      const size_t off = ok ? base + (size_t)(k0 + row) * C + c8 * 8 : base;
      cp_async16(kd + row * LDS + c8 * 8, k + off, ok);
      cp_async16(vd + row * LDS + c8 * 8, v + off, ok);
    }
  };

  load_tile(0, 0);
  cp_async_commit();  // group 0: Q and tile 0

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max, scaled log2 units
  float l_run[2] = {0.f, 0.f};              // this thread's partial row sums

  const __nv_bfloat16* qw = qs + (warp * 16) * LDS;

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* kt = ks + stage * BN * LDS;
    const __nv_bfloat16* vt = vs + stage * BN * LDS;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4(a0, a1, a2, a3, qw + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                    ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], a0, a1, a2, a3, b0, b1);
        mma16816(s[2 * np + 1], a0, a1, a2, a3, b2, b3);
      }
    }

    // online softmax over the tile; keys past Sk in this half are masked
    const int kbase = (t % tiles_per_half) * BN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kbase + n * 8 + tig * 2 + (e & 1);
        float x = col < Sk ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m_run[hr], mx[hr]);
      corr[hr] = exp2f(m_run[hr] - m_new);
      m_run[hr] = m_new;
      l_run[hr] *= corr[hr];
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P's accumulator layout is the A operand of the k16 step
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t a0 = pack_bf16(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack_bf16(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int np = 0; np < (NT + 1) / 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3,
                  vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + np * 16 +
                      (lane >> 4) * 8);
        mma16816(o[2 * np], a0, a1, a2, a3, b0, b1);
        if (2 * np + 1 < NT) mma16816(o[2 * np + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    __syncthreads();  // the stage is overwritten by the next iteration's load
  }

  // normalise and store; rows past Sq are not stored
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
  }
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  __nv_bfloat16* ob = out + ((size_t)r * Sq) * C + (size_t)h * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + tig * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + col) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int rows, int Sq,
                   int Sk, int H, int frames, float scale, cudaStream_t stream) {
  constexpr int LDS = (D + 15) / 16 * 16 + 8;
  const size_t smem = (size_t)(BM + 4 * BN) * LDS * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BM - 1) / BM, H, rows);
  flash_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, H, frames,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int rows, int Sq,
                     int Sk, int H, int d, int frames, float scale, cudaStream_t st) {
  if (rows < 1 || rows > 65535 || Sq < 1 || Sk < 1 || H < 1 || H > 65535)
    return cudaErrorInvalidValue;
  switch (d) {
#define FLASH_CASE(D) \
  case D:             \
    return launch<D>(q, k, v, out, rows, Sq, Sk, H, frames, scale, st);
    FLASH_CASE(8) FLASH_CASE(16) FLASH_CASE(24) FLASH_CASE(32) FLASH_CASE(40)
    FLASH_CASE(48) FLASH_CASE(56) FLASH_CASE(64) FLASH_CASE(72) FLASH_CASE(80)
    FLASH_CASE(88) FLASH_CASE(96) FLASH_CASE(104) FLASH_CASE(112) FLASH_CASE(120)
    FLASH_CASE(128) FLASH_CASE(136) FLASH_CASE(144) FLASH_CASE(152) FLASH_CASE(160)
#undef FLASH_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------------
// d = 512: the f4 VAE decoder's mid attention, one head over all 163,840
// latent positions of a 320x512 frame (4*S^2*d = 5.5e13 flops per frame,
// 56 ms at 989 TFLOP/s; the fp32 scores would be 107 GB per frame). A
// 16 x 512 fp32 output tile is 256 registers a thread, above the limit, so
// the output columns are split: a block of 8 warps owns 64 queries; warps
// w and w^4 share 16 of them and each keeps the output for its half of d
// (16 x 256 fp32, 128 registers). Each computes Q.K^T over its half of d
// for the 32-key tile; the two partial score tiles are summed through
// shared memory (in the same order on both sides, so both hold the same
// scores and take identical online-softmax steps); then each multiplies
// P by its half of V. Q (64 x 512) stays in shared memory; K and V tiles
// of 32 keys are double-buffered by cp.async (216 KB in all).
// ----------------------------------------------------------------------------

constexpr int WBM = 64, WBN = 32, WD = 512, WLDS = WD + 8, WTHREADS = 256;
constexpr size_t WSMEM = (size_t)(WBM + 4 * WBN) * WLDS * 2 + 8 * 32 * 16 * 4;

__global__ void __launch_bounds__(WTHREADS, 1) flash_wide_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
    float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [WBM][WLDS]
  __nv_bfloat16* ks = qs + WBM * WLDS;                             // [2][WBN][WLDS]
  __nv_bfloat16* vs = ks + 2 * WBN * WLDS;                         // [2][WBN][WLDS]
  float* xch = reinterpret_cast<float*>(vs + 2 * WBN * WLDS);      // [8 warps][32 lanes][16]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int rg = warp & 3, hf = warp >> 2;  // query rows rg*16.., channels hf*256..
  const int r = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * WBM;
  const size_t C = (size_t)H * WD;
  constexpr int NC = WD / 8;  // 16-byte chunks per row

  {
    const __nv_bfloat16* qb = q + (size_t)r * Sq * C + (size_t)h * WD;
    for (int idx = tid; idx < WBM * NC; idx += WTHREADS) {
      const int row = idx / NC, c8 = idx - row * NC;
      const bool ok = q0 + row < Sq;
      cp_async16(qs + row * WLDS + c8 * 8, ok ? qb + (size_t)(q0 + row) * C + c8 * 8 : qb, ok);
    }
  }
  const size_t kvbase = (size_t)r * Sk * C + (size_t)h * WD;
  auto load_tile = [&](int t, int stage) {
    const int k0 = t * WBN;
    for (int idx = tid; idx < WBN * NC; idx += WTHREADS) {
      const int row = idx / NC, c8 = idx - row * NC;
      const bool ok = k0 + row < Sk;
      const size_t off = ok ? kvbase + (size_t)(k0 + row) * C + c8 * 8 : kvbase;
      cp_async16(ks + (stage * WBN + row) * WLDS + c8 * 8, k + off, ok);
      cp_async16(vs + (stage * WBN + row) * WLDS + c8 * 8, v + off, ok);
    }
  };
  const int ntiles = (Sk + WBN - 1) / WBN;
  load_tile(0, 0);
  cp_async_commit();

  float o[WD / 2 / 8][4];
#pragma unroll
  for (int n = 0; n < WD / 2 / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const __nv_bfloat16* qw = qs + (rg * 16) * WLDS + hf * (WD / 2);
  float* mine = xch + (warp * 32 + lane) * 16;
  const float* theirs = xch + ((warp ^ 4) * 32 + lane) * 16;

  for (int t = 0; t < ntiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < ntiles) {
      load_tile(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * WBN * WLDS + hf * (WD / 2);
    const __nv_bfloat16* vt = vs + stage * WBN * WLDS + hf * (WD / 2);

    float s[WBN / 8][4];
#pragma unroll
    for (int n = 0; n < WBN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < WD / 2 / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4(a0, a1, a2, a3, qw + (lane & 15) * WLDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < WBN / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * WLDS + kk * 16 +
                    ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], a0, a1, a2, a3, b0, b1);
        mma16816(s[2 * np + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    // sum the two halves of d through shared memory
#pragma unroll
    for (int n = 0; n < WBN / 8; ++n)
      *reinterpret_cast<float4*>(mine + n * 4) = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    __syncthreads();
    const int kbase = t * WBN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < WBN / 8; ++n) {
      const float4 p = *reinterpret_cast<const float4*>(theirs + n * 4);
      const float pe[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kbase + n * 8 + tig * 2 + (e & 1);
        const float x = col < Sk ? (s[n][e] + pe[e]) * scale_log2 : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m_run[hr], mx[hr]);
      corr[hr] = exp2f(m_run[hr] - m_new);
      m_run[hr] = m_new;
      l_run[hr] *= corr[hr];
    }
#pragma unroll
    for (int n = 0; n < WBN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < WD / 2 / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
#pragma unroll
    for (int j = 0; j < WBN / 16; ++j) {
      const uint32_t a0 = pack_bf16(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack_bf16(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int np = 0; np < WD / 2 / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3,
                  vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WLDS + np * 16 +
                      (lane >> 4) * 8);
        mma16816(o[2 * np], a0, a1, a2, a3, b0, b1);
        mma16816(o[2 * np + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    __syncthreads();  // the stage and the exchange slots are reused next
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
    l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
  }
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
  const int row0 = q0 + rg * 16 + g, row1 = row0 + 8;
  __nv_bfloat16* ob = out + (size_t)r * Sq * C + (size_t)h * WD + hf * (WD / 2);
#pragma unroll
  for (int n = 0; n < WD / 2 / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + col) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

// q, out: (B, Sq, H*512); k, v: (B, Sk, H*512); bf16, contiguous, 16-byte
// aligned; d must be 512. Returns cudaGetLastError().
extern "C" int flash_attention_d512_bf16(const void* q, const void* k, const void* v, void* out,
                                         int B, int Sq, int Sk, int H, int d, float scale,
                                         void* stream) {
  if (d != WD || B < 1 || B > 65535 || Sq < 1 || Sk < 1 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)WSMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + WBM - 1) / WBM, H, B);
  flash_wide_kernel<<<grid, WTHREADS, WSMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), Sq, Sk, H,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// q, k, v, out: (BF, S, H*d) bf16, contiguous, 16-byte aligned; BF a
// multiple of F. Keys/values of row r: concat(row r - r%F, row r-1 or r).
// Requires d % 8 == 0, d <= 160. Returns cudaGetLastError().
extern "C" int flash_sparse_causal_bf16(const void* q, const void* k, const void* v, void* out,
                                        int BF, int F, int S, int H, int d, float scale,
                                        void* stream) {
  if (F < 1 || BF % F != 0) return (int)cudaErrorInvalidValue;
  return (int)dispatch(q, k, v, out, BF, S, S, H, d, F, scale, static_cast<cudaStream_t>(stream));
}

// q, out: (B, Sq, H*d); k, v: (B, Sk, H*d); bf16, contiguous, 16-byte
// aligned. Requires d % 8 == 0, d <= 160. Returns cudaGetLastError().
extern "C" int flash_attention_kv_bf16(const void* q, const void* k, const void* v, void* out,
                                       int B, int Sq, int Sk, int H, int d, float scale,
                                       void* stream) {
  return (int)dispatch(q, k, v, out, B, Sq, Sk, H, d, 0, scale, static_cast<cudaStream_t>(stream));
}
