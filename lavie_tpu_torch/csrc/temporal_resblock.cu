// Fused GroupNorm-apply -> SiLU -> k-tap frame-axis convolution of the VSR
// ResnetBlock3DCNN, with the conv bias (time embedding folded in) and the
// block residual in the fp32 accumulator:
//   y[b,f,s,o] = bias[b,o] + sum_j sum_c act[b,f+j-k/2,s,c] W[j,o,c] (+ res[b,f,s,o])
//   act = bf16(silu_fp32(bf16(bf16(x * bf16(w[b,c])) + bf16(u[b,c])))), each op rounded,
//   silu(t) = t * (1 / (1 + e^-t)) as the TPU body orders it
// or, with activation "none", act = x (w and u are not read). Frames
// outside [0, F) contribute nothing (zero padding of the activated input).
// x, W, res, y bf16; w, u, bias fp32. Optionally (emit_stats) it also
// returns the per-(b, o) sums over (F, S) of y and of y*y, in fp32, of the
// bf16-rounded values it stores: the moments a following GroupNorm needs,
// without a second read of y.
//
// Replaces: lavie_tpu/kernels/temporal_resblock.py
//   gn_silu_tconv     (_conv_4d, body _kernel)      frame-major (B, F, S, C)
//   gn_silu_tconv_sfc (_conv_sfc, body _kernel_sfc) token-major (B, S, F, C)
// with their float options (activation "silu" | "none", emit_stats) and
// the int8 variant of the latter. The port keeps video frame-major at both
// call sites, so these kernels take that layout only (XLA's conv layout is
// what made the token-major form).
//
// What bounds it on the H100: tensor-core operations. At the VSR L0 level
// (S = 163840, C = O = 256, F = 8, k = 5) the taps that land inside the
// window are 34 of 40, 2*34*S*C*O = 0.73 TFLOP, ~0.74 ms at 989 TFLOP/s,
// against 2*2*F*S*C bytes (1.3 GB, 0.40 ms at 3.35 TB/s). The statistics
// add O(F*S*O) flops and 2*B*F*ceil(S/64)*O*4 bytes of partial sums (21 MB
// at L0, against the 671 MB read of y they save).
//
// What the float design does about it: an activation pass, then one
// implicit GEMM on wgmma (entry gn_silu_tconv_bf16).
//   tconv_act_kernel activates each element once (the TPU body activates
//     each frame once and reuses it across taps), act (B, F, S, C) bf16:
//     2 x 671 MB of HBM at L0, 0.40 ms. With activation "none" there is no
//     pass and the GEMM reads x.
//   tconv_gemm_kernel<BN>: persistent, warp-specialised (csrc/wgmma_gemm.cuh,
//     the pieces GEGLU runs on). An output tile is 128 positions x BN output
//     channels (256, or 128 where O % 256 != 0) of one (b, f); both consumer
//     warpgroups work on it, 64 rows each, one m64nBNk16 accumulator. K walks
//     the valid taps j of frame f by 64-channel slabs: one producer thread
//     keeps a ring of TMA loads in flight, A from a 4-D map over act as
//     (C, S, F, B) at (c, s0, f + j - k/2, b), which zero-fills past C (C =
//     32) and past S, and B, the tap's (BN, 64) slab of W (k * O, C), both in
//     128-byte swizzled boxes. Tiles walk the O tiles fastest, then the
//     frames, then the position tiles, so the blocks running together share
//     each activated frame tile through L2 across its taps. The epilogue adds
//     bias and the residual (brought by TMA into the warpgroup's swizzled
//     staging box while the products run) in fp32, rounds once, and stores
//     by TMA from the same box, whose rows past S are not written.
//   Statistics: after its store each warpgroup sums its 64 rows of the
//     rounded tile from the staging box per column (the ragged S tail
//     masked), one row of partials per (b, f, 64 positions) in an fp32
//     scratch (B, F*2*ceil(S/128), O). colsum_kernel then sums the partials
//     128 rows per block, in a fixed order, pass after pass until one row is
//     left. No atomics: the sums are the same from run to run.
//
// The int8 variant (entry gn_silu_tconv_int8_bf16) replaces the JAX
// package's quant="int8" of gn_silu_tconv_sfc (_kernel_sfc's turbo body):
// act, rounded to bf16 (silu as x / (1 + e^-x): the variant's results are
// kept bit for bit since it was ported), is quantised with one symmetric
// scale per (batch, block of `blk` positions) shared by all F frames,
// a_scale = max(max|act|, 1e-12) / 127, q = clamp(rn(act * (1 / a_scale)),
// +-127); the taps arrive quantised per output channel (w_scale, by the
// wrapper); the k taps accumulate in int32 and y = float(iacc) * (a_scale *
// w_scale[o]) + bias (+ res), rounded to bf16, multiplies and adds rounded
// one by one as in the JAX package. act_scale_kernel first reduces max|act|
// per (b, block) (max is exact, so the scale is the same from run to run)
// and writes a_scale and 1 / a_scale; tconv_int8_kernel then runs a GEMM
// per (batch, frame) whose A operand is activated and quantised on the fly
// into 64-byte shared rows of 64 int8 channels: a block owns 128 positions x
// 128 output channels of one frame, 8 warps on mma.sync m16n8k32 (s8 x s8 ->
// s32) fed by ldmatrix, the taps by cp.async, double-buffered; its
// statistics sum each block's tile in shared memory, one partial row per
// (b, f, 128 positions). Bound on the H100: 2*valid_taps*S*C*O operations
// at the int8 rate (1979 TOPS) against 2*2*F*S*C bytes: at VSR L0 (k=5)
// 0.37 ms of operations, 0.40 ms of bytes; the pre-pass reads x once more.

#include <stdint.h>

#include "wgmma_gemm.cuh"

namespace {

using namespace wgemm;

// the int8 kernel's tile and K chunk
constexpr int I8_ROWS = 128, I8_COLS = 128, BK = 32;  // BK bf16 (64 bytes) per K chunk
constexpr int LDS = BK + 8;  // shared row stride (bf16 elements)
constexpr int I8_THREADS = 256;
constexpr int MAX_C = 1024;
constexpr int RED_ROWS = 128;  // partial rows one colsum_kernel block sums

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16832(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16(bf16(v * w) + u) for two channels packed in a 32-bit word. mul.rn
// and add.rn name their rounding, which keeps ptxas from fusing them into
// one fma: with __hmul and __hadd it did, and that single rounding differed
// from the plain version's two in 21% of the activations (H100 80GB HBM3,
// 700 W) and, through the int8 variant's block max, moved whole blocks of
// its quantisation grid.
__device__ __forceinline__ float2 gn_affine2(uint32_t v, uint32_t w, uint32_t u) {
  uint32_t p, t;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(p) : "r"(v), "r"(w));
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(t) : "r"(p), "r"(u));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t));
}

// the int8 variant's activation: bf16(t / (1 + e^-t)) of the affine
__device__ __forceinline__ uint32_t gn_silu2(uint32_t v, uint32_t w, uint32_t u) {
  const float2 f = gn_affine2(v, w, u);
  const __nv_bfloat162 a = __floats2bfloat162_rn(f.x / (1.f + expf(-f.x)), f.y / (1.f + expf(-f.y)));
  return *reinterpret_cast<const uint32_t*>(&a);
}

// the float kernel's activation, in the TPU body's order:
// bf16(t * (1 / (1 + e^-t))) of the affine (lavie_tpu/kernels/temporal_resblock.py::_silu)
__device__ __forceinline__ uint32_t gn_silu2_tpu(uint32_t v, uint32_t w, uint32_t u) {
  const float2 f = gn_affine2(v, w, u);
  return pack_bf16(__fmul_rn(f.x, __frcp_rn(1.f + expf(-f.x))),
                   __fmul_rn(f.y, __frcp_rn(1.f + expf(-f.y))));
}

// the pair of bf16 at p (p 4-byte aligned) as one word
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// part1, part2: (B, F*gridDim.x, O) column partials of y and y*y, or null.
// wt holds int8 taps (k, O, C); qs (B, ceil(S/blk), 2) a_scale and
// 1/a_scale per (b, block of blk positions); wsc (O) the taps' scales.
// Two blocks an SM: the extra A registers would otherwise take it to 164
// registers a thread and one block an SM.
template <bool SILU>
__global__ void __launch_bounds__(I8_THREADS, 2) tconv_int8_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wn,
    const float* __restrict__ un, const int8_t* __restrict__ wt,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ y, float* __restrict__ part1, float* __restrict__ part2,
    const float* __restrict__ qs, const float* __restrict__ wsc, int blk, int F, int S, int C,
    int O, int K) {
  // int8 channels per K chunk: 64 bytes of a shared row
  constexpr int CHUNK = 2 * BK;
  constexpr int PIECES = CHUNK / 8;                     // 8-channel pieces of a row
  constexpr int APIECES = I8_ROWS * PIECES / I8_THREADS;  // those this thread loads
  __shared__ __align__(16) __nv_bfloat16 as[2][I8_ROWS * LDS];
  __shared__ __align__(16) __nv_bfloat16 bs[2][I8_COLS * LDS];
  __shared__ __align__(16) __nv_bfloat16 wsh[MAX_C], ush[MAX_C];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn_ = warp >> 2;
  const int s0 = blockIdx.x * I8_ROWS, n0 = blockIdx.y * I8_COLS;
  const int b = blockIdx.z / F, f = blockIdx.z - b * F;
  const int pad = K / 2;

  // element (b, f, s, 0) of an activation with `ch` channels
  auto at = [&](int ff, int s, int ch) -> size_t {
    return (((size_t)b * F + ff) * S + s) * ch;
  };

  if (SILU) {
    for (int c = tid; c < C; c += I8_THREADS) {
      wsh[c] = __float2bfloat16(wn[(size_t)b * C + c]);
      ush[c] = __float2bfloat16(un[(size_t)b * C + c]);
    }
  }

  const int jlo = max(0, pad - f), jhi = min(K, F + pad - f);
  const int kchunks = C / CHUNK;
  const int n_it = (jhi - jlo) * kchunks;
  const int nblk = (S + blk - 1) / blk;

  // this thread's 16-byte pieces of each A chunk (8 channels each), and
  // the 1/a_scale of each piece's row (rows past S quantise to 0)
  uint4 areg[APIECES];
  float ainv[APIECES];
#pragma unroll
  for (int r = 0; r < APIECES; ++r) {
    const int s = s0 + (tid + r * I8_THREADS) / PIECES;
    ainv[r] = s < S ? qs[((size_t)b * nblk + s / blk) * 2 + 1] : 0.f;
  }
  auto load_a = [&](int it) {
    const int j = jlo + it / kchunks, k0 = (it % kchunks) * CHUNK;
    const int fsrc = f + j - pad;
#pragma unroll
    for (int r = 0; r < APIECES; ++r) {
      const int idx = tid + r * I8_THREADS, row = idx / PIECES, c8 = idx % PIECES;
      areg[r] = make_uint4(0, 0, 0, 0);
      if (s0 + row < S)
        areg[r] = *reinterpret_cast<const uint4*>(x + at(fsrc, s0 + row, C) + k0 + c8 * 8);
    }
  };
  auto store_a = [&](int it, int stage) {
    const int k0 = (it % kchunks) * CHUNK;
#pragma unroll
    for (int r = 0; r < APIECES; ++r) {
      const int idx = tid + r * I8_THREADS, row = idx / PIECES, c8 = idx % PIECES;
      __nv_bfloat16 v[8];
      *reinterpret_cast<uint4*>(v) = areg[r];
      if (SILU) {
        uint32_t* vp = reinterpret_cast<uint32_t*>(v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + c8 * 8 + 2 * e;
          vp[e] = gn_silu2(vp[e], pair(wsh + c), pair(ush + c));
        }
      }
      uint32_t packed[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int qv = __float2int_rn(__fmul_rn(__bfloat162float(v[e]), ainv[r]));
        qv = min(127, max(-127, qv));
        packed[e >> 2] |= (uint32_t)(qv & 0xff) << (8 * (e & 3));
      }
      // byte c8 * 8 of the 64-byte row
      *reinterpret_cast<uint2*>(&as[stage][row * LDS + c8 * 4]) = make_uint2(packed[0], packed[1]);
    }
  };
  auto load_b = [&](int it, int stage) {
    const int j = jlo + it / kchunks, k0 = (it % kchunks) * CHUNK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * I8_THREADS, row = idx >> 2, c16 = idx & 3;  // 16-byte piece
      const size_t src = ((size_t)j * O + n0 + row) * C + k0;
      cp_async16(&bs[stage][row * LDS + c16 * 8], wt + src + c16 * 16);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  __syncthreads();  // wsh/ush
  if (n_it > 0) {
    load_a(0);
    load_b(0, 0);
    cp_async_commit();
    store_a(0, 0);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int it = 0; it < n_it; ++it) {
    const int cur = it & 1;
    const bool next = it + 1 < n_it;
    if (next) {
      load_a(it + 1);
      load_b(it + 1, cur ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* at_ = as[cur];
    const __nv_bfloat16* bt = bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                at_ + (wm * 32 + mt * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                bt + (wn_ * 64 + np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                    ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16832(acc[mt][2 * np], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
          mma16832(acc[mt][2 * np + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b2, b3);
        }
      }
    }
    if (next) {
      store_a(it + 1, cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // epilogue: + bias (+ residual) in fp32, store bf16; rows past S are not
  // stored; cs1/cs2 sum this thread's stored values per column
  float cs1[8][2], cs2[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) cs1[nt][0] = cs1[nt][1] = cs2[nt][0] = cs2[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int s = s0 + wm * 32 + mt * 16 + g + hr * 8;
      if (s >= S) continue;
      const size_t base = at(f, s, O);
      const float a_scale = qs[((size_t)b * nblk + s / blk) * 2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn_ * 64 + nt * 8 + tig * 2;
        // float(iacc) * (a_scale * w_scale) + bias, each op rounded
        float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * hr]), __fmul_rn(a_scale, wsc[col])),
                             bias[(size_t)b * O + col]);
        float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * hr + 1]),
                                       __fmul_rn(a_scale, wsc[col + 1])),
                             bias[(size_t)b * O + col + 1]);
        if (res != nullptr) {
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + base + col);
          v0 += __bfloat162float(r2.x);
          v1 += __bfloat162float(r2.y);
        }
        const __nv_bfloat162 o2 = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(y + base + col) = o2;
        const float2 r = __bfloat1622float2(o2);
        cs1[nt][0] += r.x;
        cs1[nt][1] += r.y;
        cs2[nt][0] = fmaf(r.x, r.x, cs2[nt][0]);
        cs2[nt][1] = fmaf(r.y, r.y, cs2[nt][1]);
      }
    }
  }
  if (part1 == nullptr) return;

  // lanes tig, tig + 4, ..., tig + 28 hold the same columns: sum over them
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs1[nt][e] += __shfl_xor_sync(0xffffffffu, cs1[nt][e], off);
        cs2[nt][e] += __shfl_xor_sync(0xffffffffu, cs2[nt][e], off);
      }
  // then over the four M-warps, through the A buffer (free after the loop's
  // last barrier): red[0 or 1][wm][column in the block]
  float* red = reinterpret_cast<float*>(&as[0][0]);
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn_ * 64 + nt * 8 + tig * 2 + e;
        red[wm * I8_COLS + col] = cs1[nt][e];
        red[(4 + wm) * I8_COLS + col] = cs2[nt][e];
      }
  }
  __syncthreads();
  if (tid < I8_COLS) {
    const float a1 = ((red[tid] + red[I8_COLS + tid]) + red[2 * I8_COLS + tid]) + red[3 * I8_COLS + tid];
    const float a2 = ((red[4 * I8_COLS + tid] + red[5 * I8_COLS + tid]) + red[6 * I8_COLS + tid]) +
                     red[7 * I8_COLS + tid];
    const size_t p = (((size_t)b * F + f) * gridDim.x + blockIdx.x) * O + n0 + tid;
    part1[p] = a1;
    part2[p] = a2;
  }
}

// o[b, chunk, :] = sum of a[b, chunk*RED_ROWS : (chunk+1)*RED_ROWS, :] over
// the rows < `rows`, for a1 and a2 at once; a (B, rows, O), o (B, chunks, O).
// One block per (128 columns, chunk, b): 8 warps stride the chunk's rows,
// each lane 4 columns; the 8 warp sums are added in order.
__global__ void __launch_bounds__(256) colsum_kernel(
    const float* __restrict__ a1, const float* __restrict__ a2, float* __restrict__ o1,
    float* __restrict__ o2, int rows, int O) {
  __shared__ float4 r1[8][32], r2[8][32];
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int col = blockIdx.x * 128 + lane * 4;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int lo = chunk * RED_ROWS, hi = min(rows, lo + RED_ROWS);
  float4 t1 = make_float4(0.f, 0.f, 0.f, 0.f), t2 = t1;
  for (int r = lo + wy; r < hi; r += 8) {
    const size_t off = ((size_t)b * rows + r) * O + col;
    const float4 u = *reinterpret_cast<const float4*>(a1 + off);
    const float4 w = *reinterpret_cast<const float4*>(a2 + off);
    t1.x += u.x; t1.y += u.y; t1.z += u.z; t1.w += u.w;
    t2.x += w.x; t2.y += w.y; t2.z += w.z; t2.w += w.w;
  }
  r1[wy][lane] = t1;
  r2[wy][lane] = t2;
  __syncthreads();
  if (wy == 0) {
    for (int k = 1; k < 8; ++k) {
      const float4 u = r1[k][lane], w = r2[k][lane];
      t1.x += u.x; t1.y += u.y; t1.z += u.z; t1.w += u.w;
      t2.x += w.x; t2.y += w.y; t2.z += w.z; t2.w += w.w;
    }
    const size_t off = ((size_t)b * gridDim.y + chunk) * O + col;
    *reinterpret_cast<float4*>(o1 + off) = t1;
    *reinterpret_cast<float4*>(o2 + off) = t2;
  }
}

// qs[b, i] = (a_scale, 1 / a_scale) of block i of `blk` positions of batch
// b: a_scale = max(max |act|, 1e-12) / 127 over its rows, all F frames and
// all C channels, act as the main kernel's A producer makes it (bf16). One
// block per (i, b); the max is exact, so its order does not matter.
template <bool SILU>
__global__ void __launch_bounds__(256) act_scale_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wn, const float* __restrict__ un,
    float* __restrict__ qs, int F, int S, int C, int blk) {
  __shared__ __align__(16) __nv_bfloat16 wsh[MAX_C], ush[MAX_C];
  __shared__ float red[8];
  const int i = blockIdx.x, b = blockIdx.y;
  if (SILU) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      wsh[c] = __float2bfloat16(wn[(size_t)b * C + c]);
      ush[c] = __float2bfloat16(un[(size_t)b * C + c]);
    }
  }
  __syncthreads();
  const int lo = i * blk, rows = min(S, lo + blk) - lo, pieces = C / 8;
  const long long n = (long long)F * rows * pieces;
  float m = 0.f;
  for (long long p = threadIdx.x; p < n; p += blockDim.x) {
    const int c8 = (int)(p % pieces);
    const long long fr = p / pieces;
    const int r = (int)(fr % rows), ff = (int)(fr / rows);
    uint4 raw = *reinterpret_cast<const uint4*>(x + (((size_t)b * F + ff) * S + lo + r) * C + c8 * 8);
    uint32_t* vp = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c8 * 8 + 2 * e;
      uint32_t a = SILU ? gn_silu2(vp[e], pair(wsh + c), pair(ush + c)) : vp[e];
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
      m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w]);
    const float a_scale = fmaxf(m, 1e-12f) / 127.f;
    qs[((size_t)b * gridDim.x + i) * 2] = a_scale;
    qs[((size_t)b * gridDim.x + i) * 2 + 1] = 1.f / a_scale;
  }
}


// ---- the float path: activation pass and implicit GEMM on wgmma ------------

constexpr int CONV_STAGES_MAX = 6;
constexpr int STAGING_ROWS = 64;  // a consumer warpgroup's rows of the output tile

// act = the activated x, 8 channels (16 bytes) a thread a step; w and u as
// the bf16 values the TPU body multiplies and adds
__global__ void __launch_bounds__(256) tconv_act_kernel(const uint4* __restrict__ x,
                                                        const float* __restrict__ wn,
                                                        const float* __restrict__ un,
                                                        uint4* __restrict__ act, long long n8,
                                                        long long per_batch8, int C) {
  const int c8s = C / 8;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % c8s) * 8;
    const size_t wb = (size_t)(i / per_batch8) * C + c;
    const float4 w0 = *reinterpret_cast<const float4*>(wn + wb);
    const float4 w1 = *reinterpret_cast<const float4*>(wn + wb + 4);
    const float4 u0 = *reinterpret_cast<const float4*>(un + wb);
    const float4 u1 = *reinterpret_cast<const float4*>(un + wb + 4);
    uint4 v = x[i];
    v.x = gn_silu2_tpu(v.x, pack_bf16(w0.x, w0.y), pack_bf16(u0.x, u0.y));
    v.y = gn_silu2_tpu(v.y, pack_bf16(w0.z, w0.w), pack_bf16(u0.z, u0.w));
    v.z = gn_silu2_tpu(v.z, pack_bf16(w1.x, w1.y), pack_bf16(u1.x, u1.y));
    v.w = gn_silu2_tpu(v.w, pack_bf16(w1.z, w1.w), pack_bf16(u1.z, u1.w));
    act[i] = v;
  }
}

struct ConvArgs {
  const float* bias;    // (B, O)
  float *part1, *part2;  // (B, F*2*s_tiles, O) column partials of y and y*y, or null
  int F, S, O, K;
  int c_blocks;  // ceil(C / 64): 64-channel slabs of K a tap
  int s_tiles;   // ceil(S / 128)
  int o_tiles;   // O / BN
  int tiles;     // B * s_tiles * F * o_tiles
  int stages;
  int has_res;
};

struct ConvTile {
  int b, f, s0, n0, jlo, jhi;  // taps jlo..jhi-1 read frames inside [0, F)
};

// tile t: O tiles fastest, then frames, then position tiles, then batch
__device__ __forceinline__ ConvTile conv_tile(const ConvArgs& a, int t, int bn) {
  ConvTile c;
  c.n0 = (t % a.o_tiles) * bn;
  t /= a.o_tiles;
  c.f = t % a.F;
  t /= a.F;
  c.s0 = (t % a.s_tiles) * BM;
  c.b = t / a.s_tiles;
  const int pad = a.K / 2;
  c.jlo = max(0, pad - c.f);
  c.jhi = min(a.K, a.F + pad - c.f);
  return c;
}

// The producer thread: for each of the block's tiles, each valid tap and
// each 64-channel slab of C, one ring stage: the A slab (128 positions of
// the source frame) and the tap's B slab (BN output channels).
template <int BN>
__device__ __forceinline__ void conv_produce(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                             const ConvArgs& a, uint32_t ring, uint32_t bars) {
  constexpr int STAGE = stage_bytes<BN>();
  const int pad = a.K / 2;
  int g = 0;  // stages issued by this block
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const ConvTile ct = conv_tile(a, t, BN);
    for (int j = ct.jlo; j < ct.jhi; ++j)
      for (int kb = 0; kb < a.c_blocks; ++kb, ++g) {
        const int s = g % a.stages;
        if (g >= a.stages) mbar_wait(bars + 8 * (MAX_STAGES + s), ((g / a.stages) - 1) & 1);
        const uint32_t full = bars + 8 * s, sa = ring + s * STAGE;
        mbar_expect_tx(full, STAGE);
        tma_load_4d(sa, tm_x, full, kb * SLAB, ct.s0, ct.f + j - pad, ct.b);
        tma_load_2d(sa + A_BYTES, tm_w, full, kb * SLAB, j * a.O + ct.n0);
      }
  }
}

// Shared memory: the ring, two staging boxes (one a consumer warpgroup:
// BN / 64 swizzled slabs of 64 rows), the ring's barriers and one residual
// barrier a consumer warpgroup.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) tconv_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_res,
    const ConvArgs a) {
  constexpr int STAGE = stage_bytes<BN>();
  constexpr int SLABS = BN / SLAB;
  constexpr int BOX = STAGING_ROWS * ROW_BYTES;  // one 64-column slab of 64 rows
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t staging = ring + a.stages * STAGE;
  const uint32_t bars = staging + 2 * SLABS * BOX;
  if (threadIdx.x == 0) {
    mbar_init(bars + 16 * MAX_STAGES, 1);
    mbar_init(bars + 16 * MAX_STAGES + 8, 1);
  }
  init_ring(bars, a.stages, 256);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) conv_produce<BN>(&tm_x, &tm_w, a, ring, bars);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, tw = threadIdx.x - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31, g8 = lane >> 2, tig = lane & 3;
  const uint32_t box = staging + c * SLABS * BOX, res_bar = bars + 16 * MAX_STAGES + 8 * c;
  float acc[BN / 2];
  int g = 0;  // stages consumed by this block
  int it = 0;  // tiles of this block so far
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++it) {
    const ConvTile ct = conv_tile(a, t, BN);
    const int r0 = ct.s0 + c * STAGING_ROWS;  // this warpgroup's first position
    if (tw == 0) {
      tma_store_wait_read<0>();  // the previous tile's store has read the box
      if (a.has_res) {  // the residual tile into the box, under the products
        mbar_expect_tx(res_bar, SLABS * BOX);
#pragma unroll
        for (int q = 0; q < SLABS; ++q) tma_load_4d(box + q * BOX, &tm_res, res_bar, ct.n0 + q * SLAB, r0, ct.f, ct.b);
      }
    }
    coop_products<BN>(acc, ring, bars, a.stages, c * STAGING_ROWS * ROW_BYTES,
                      (ct.jhi - ct.jlo) * a.c_blocks, g);
    if (a.has_res)
      mbar_wait(res_bar, it & 1);
    else
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c));  // the box is free

    // epilogue: acc[4j + e] is row warp * 16 + g8 + 8 * (e / 2), column
    // 8j + 2 * tig + e % 2 of the tile: 16-byte chunk j % 8 of its row in
    // slab j / 8 of the box
    const float* bb = a.bias + (size_t)ct.b * a.O + ct.n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 bv = bias2(bb + 8 * j + 2 * tig);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t addr = box + (j / 8) * BOX + swizzled(warp * 16 + g8 + 8 * h, j % 8) + tig * 4;
        float v0 = acc[4 * j + 2 * h] + bv.x, v1 = acc[4 * j + 2 * h + 1] + bv.y;
        if (a.has_res) {
          uint32_t rv;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(rv) : "r"(addr));
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
          v0 += r.x;
          v1 += r.y;
        }
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(pack_bf16(v0, v1)));
      }
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c));
    if (tw == 0) {  // positions past S are not written
#pragma unroll
      for (int q = 0; q < SLABS; ++q) tma_store_4d(&tm_y, box + q * BOX, ct.n0 + q * SLAB, r0, ct.f, ct.b);
      tma_store_commit();
    }
    if (a.part1 != nullptr) {
      // thread tw sums columns 2tw, 2tw + 1 of the stored tile over this
      // warpgroup's positions inside S, in row order
      const int rows = min(STAGING_ROWS, a.S - r0);
      if (tw < BN / 2) {
        const int col = 2 * tw;
        const uint32_t base = box + (col / SLAB) * BOX + ((col % SLAB) % 8) * 2;
        float2 s1 = make_float2(0.f, 0.f), s2 = s1;
        for (int r = 0; r < rows; ++r) {
          uint32_t v;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(base + swizzled(r, (col % SLAB) / 8)));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
          s1.x += y.x;
          s1.y += y.y;
          s2.x = fmaf(y.x, y.x, s2.x);
          s2.y = fmaf(y.y, y.y, s2.y);
        }
        const size_t p = ((((size_t)ct.b * a.F + ct.f) * a.s_tiles + ct.s0 / BM) * 2 + c) * a.O +
                         ct.n0 + col;
        *reinterpret_cast<float2*>(a.part1 + p) = s1;
        *reinterpret_cast<float2*>(a.part2 + p) = s2;
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c));  // the box is read
    }
  }
  if (tw == 0) tma_store_wait<0>();
}

// the float kernel's shared bytes: ring, staging boxes, barriers
int conv_smem(int bn, int stages) {
  return ring_smem(stages, (BM + bn) * ROW_BYTES, 2 * bn * STAGING_ROWS * 2 + 16);
}

template <int BN>
cudaError_t launch_conv(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
                        const CUtensorMap& mr, const ConvArgs& a, int grid, cudaStream_t st) {
  const int smem = conv_smem(BN, a.stages);
  cudaError_t err = set_smem((const void*)tconv_gemm_kernel<BN>, smem);
  if (err != cudaSuccess) return err;
  tconv_gemm_kernel<BN><<<grid < a.tiles ? grid : a.tiles, THREADS, smem, st>>>(mx, mw, my, mr, a);
  return cudaGetLastError();
}


// partial rows of the statistics per batch row: one per (frame, 64
// positions) for the float kernel, one per (frame, 128 positions) for the
// int8 kernel
long long float_partial_rows(int F, int S) { return (long long)F * 2 * ((S + BM - 1) / BM); }
long long int8_partial_rows(int F, int S) { return (long long)F * ((S + I8_ROWS - 1) / I8_ROWS); }

// The statistics from (B, p, O) partials part1 and part1 + B*p*O in the
// workspace ws: summed RED_ROWS rows per block until one row is left, the
// passes alternating between the tail of ws and its head, into s1 and s2.
int column_sums(float* ws, long long p, int B, int O, void* s1, void* s2, cudaStream_t st) {
  const long long n_part = (long long)B * p * O;
  float* part1 = ws;
  float* tail = part1 + 2 * n_part;
  const float *src1 = part1, *src2 = part1 + n_part;
  long long rows = p;
  bool to_tail = true;
  while (true) {
    const long long chunks = (rows + RED_ROWS - 1) / RED_ROWS;
    if (chunks > 65535) return (int)cudaErrorInvalidValue;
    float *dst1, *dst2;
    if (chunks == 1) {
      dst1 = static_cast<float*>(s1);
      dst2 = static_cast<float*>(s2);
    } else {
      dst1 = to_tail ? tail : part1;
      dst2 = dst1 + (long long)B * chunks * O;
    }
    colsum_kernel<<<dim3(O / 128, (unsigned)chunks, B), 256, 0, st>>>(src1, src2, dst1, dst2,
                                                                      (int)rows, O);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return (int)err;
    src1 = dst1;
    src2 = dst2;
    rows = chunks;
    to_tail = !to_tail;
  }
}

bool bad_shape(int B, int F, int S, int C, int O, int K, int chunk, void* ws, void* s1, void* s2) {
  return B < 1 || F < 1 || S < 1 || C < chunk || C % chunk || C > MAX_C || O % 128 || O < 128 ||
         K % 2 == 0 || K > 7 || (long long)B * F > 65535 || O / 128 > 65535 ||
         (ws != nullptr && (s1 == nullptr || s2 == nullptr));
}

}  // namespace

// Floats of scratch that gn_silu_tconv_bf16 and gn_silu_tconv_int8_bf16 need
// to emit statistics.
extern "C" long long gn_silu_tconv_workspace_floats(int B, int F, int S, int O) {
  const long long p = float_partial_rows(F, S);
  return 2LL * B * O * (p + (p + RED_ROWS - 1) / RED_ROWS);
}

// x (B,F,S,C); res and y (B,F,S,O); w, u (B,C) fp32, not read when silu is
// 0; wt (k,O,C) bf16; bias (B,O) fp32; res may be null. act: bf16 scratch
// of B*F*S*C for the activated input (not read when silu is 0). With a
// workspace ws of gn_silu_tconv_workspace_floats floats, s1 and s2 (B,O)
// fp32 receive the sums over (F, S) of y and y*y; ws null emits nothing.
// The launch plan (kernels/temporal_resblock.py::launch_plan): the tile
// width bn (128 or 256, dividing O), `stages` ring stages, at most `grid`
// persistent blocks. Requires C % 32 == 0, C <= 1024, O % 128 == 0, odd
// k <= 7, contiguous 16-byte aligned tensors. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape or plan the kernels cannot take.
extern "C" int gn_silu_tconv_bf16(const void* x, const void* w, const void* u, const void* wt,
                                  const void* bias, const void* res, void* y, void* act, void* ws,
                                  void* s1, void* s2, int B, int F, int S, int C, int O, int K,
                                  int silu, int bn, int stages, int grid, void* stream) {
  if (bad_shape(B, F, S, C, O, K, BK, ws, s1, s2) || (bn != 128 && bn != 256) || O % bn ||
      stages < 2 || stages > CONV_STAGES_MAX || grid < 1 || (silu && act == nullptr) ||
      conv_smem(bn, stages) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* a_src = x;
  if (silu) {
    const long long n8 = (long long)B * F * S * C / 8;
    const long long blocks = (n8 + 255) / 256, cap = 16LL * sm_count();
    tconv_act_kernel<<<(unsigned)(blocks < cap ? blocks : cap), 256, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<const float*>(w), static_cast<const float*>(u),
        static_cast<uint4*>(act), n8, (long long)F * S * C / 8, C);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a_src = act;
  }
  CUtensorMap m_x, m_w, m_y, m_r;
  if (!make_map_4d(&m_x, a_src, C, S, F, B, BM) || !make_map_2d(&m_w, wt, C, K * O, bn) ||
      !make_map_4d(&m_y, y, O, S, F, B, STAGING_ROWS) ||
      !make_map_4d(&m_r, res != nullptr ? res : y, O, S, F, B, STAGING_ROWS))
    return (int)cudaErrorNotSupported;
  const long long p = float_partial_rows(F, S), n_part = (long long)B * p * O;
  float* part1 = static_cast<float*>(ws);
  const int s_tiles = (S + BM - 1) / BM;
  const long long tiles = (long long)B * s_tiles * F * (O / bn);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const ConvArgs a{static_cast<const float*>(bias), part1, part1 ? part1 + n_part : nullptr,
                   F, S, O, K, (C + SLAB - 1) / SLAB, s_tiles, O / bn, (int)tiles, stages,
                   res != nullptr};
  const cudaError_t err = bn == 256 ? launch_conv<256>(m_x, m_w, m_y, m_r, a, grid, st)
                                    : launch_conv<128>(m_x, m_w, m_y, m_r, a, grid, st);
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  return column_sums(part1, p, B, O, s1, s2, st);
}

// The int8 variant: as gn_silu_tconv_bf16 without the plan and the act
// scratch, with wq (k,O,C) int8 taps and wsc (O) fp32 their
// per-output-channel scales; blk positions share one activation scale; qs,
// scratch of B * ceil(S / blk) * 2 floats, receives (a_scale, 1 / a_scale)
// per block. Requires C % 64 == 0.
extern "C" int gn_silu_tconv_int8_bf16(const void* x, const void* w, const void* u, const void* wq,
                                       const void* wsc, const void* bias, const void* res, void* y,
                                       int B, int F, int S, int C, int O, int K, int silu, int blk,
                                       void* qs, void* ws, void* s1, void* s2, void* stream) {
  if (bad_shape(B, F, S, C, O, K, 2 * BK, ws, s1, s2) || blk < 1 || qs == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (S + blk - 1) / blk;
  const auto scale = silu ? act_scale_kernel<true> : act_scale_kernel<false>;
  scale<<<dim3(nblk, B), 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                       static_cast<const float*>(w), static_cast<const float*>(u),
                                       static_cast<float*>(qs), F, S, C, blk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long p = int8_partial_rows(F, S), n_part = (long long)B * p * O;
  float* part1 = static_cast<float*>(ws);
  const dim3 grid((S + I8_ROWS - 1) / I8_ROWS, O / I8_COLS, B * F);
  const auto kernel = silu ? tconv_int8_kernel<true> : tconv_int8_kernel<false>;
  kernel<<<grid, I8_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const int8_t*>(wq), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(y), part1,
      part1 ? part1 + n_part : nullptr, static_cast<const float*>(qs),
      static_cast<const float*>(wsc), blk, F, S, C, O, K);
  err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  return column_sums(part1, p, B, O, s1, s2, st);
}
