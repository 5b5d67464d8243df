// Fused GroupNorm-apply -> SiLU -> k-tap frame-axis convolution of the VSR
// ResnetBlock3DCNN, with the conv bias (time embedding folded in) and the
// block residual in the fp32 accumulator:
//   y[b,f,s,o] = bias[b,o] + sum_j sum_c act[b,f+j-k/2,s,c] W[j,o,c] (+ res[b,f,s,o])
//   act = bf16(silu_fp32(bf16(bf16(x * bf16(w[b,c])) + bf16(u[b,c])))), each op rounded
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
// with their float options (activation "silu" | "none", emit_stats). The
// port keeps video frame-major at both call sites, so this kernel takes that
// layout only (XLA's conv layout is what made the token-major form).
//
// What bounds it on the H100: tensor-core operations. At the VSR L0 level
// (S = 163840, C = O = 256, F = 8, k = 5) the taps that land inside the
// window are 34 of 40, 2*34*S*C*O = 0.73 TFLOP, ~0.74 ms at 989 TFLOP/s,
// against 2*2*F*S*C bytes (1.3 GB, 0.40 ms at 3.35 TB/s). The unfused chain
// would also write and read back the normalised and activated tensors. The
// statistics add O(F*S*O) flops and 2*B*F*ceil(S/128)*O*4 bytes of partial
// sums (21 MB at L0, against the 671 MB read of y they save).
//
// What the design does about it: it is a GEMM per (batch, frame) whose
// A operand is produced on the fly. A block owns 128 positions x 128 output
// channels of one frame and walks K = (valid taps) x C in chunks of 32: the
// x chunk of the source frame is loaded into registers one iteration ahead,
// normalised, activated and rounded as it is written to shared memory; the
// tap's weight chunk arrives by cp.async. Both are double-buffered. 8 warps
// (4 x 2) each own a 32 x 64 accumulator tile on mma.sync m16n8k16 (bf16 in,
// fp32 accumulate, fragments by ldmatrix). Shared rows are padded by 16
// bytes so ldmatrix's eight row reads hit distinct banks. The activated
// input is recomputed for each tap and each output tile: elementwise work,
// small next to the products. Later work (ROADMAP): wgmma, TMA, keeping the
// activated frame tiles resident across taps.
//
// Statistics: each block sums its rounded output tile over its valid rows
// (the ragged S tail masked), first across the accumulator fragment's row
// lanes by warp shuffles, then across the four M-warps through shared
// memory, and writes one row of column partials per block to an fp32
// scratch (B, F*ceil(S/128), O). colsum_kernel then sums the partials 128
// rows per block, in a fixed order, pass after pass until one row is left.
// No atomics: the sums are the same from run to run.
//
// The int8 variant (entry gn_silu_tconv_int8_bf16) replaces the JAX
// package's quant="int8" of gn_silu_tconv_sfc (_kernel_sfc's turbo body):
// act, rounded to bf16 as above, is quantised with one symmetric scale per
// (batch, block of `blk` positions) shared by all F frames, a_scale =
// max(max|act|, 1e-12) / 127, q = clamp(rn(act * (1 / a_scale)), +-127); the
// taps arrive quantised per output channel (w_scale, by the wrapper); the
// k taps accumulate in int32 and y = float(iacc) * (a_scale * w_scale[o]) +
// bias (+ res), rounded to bf16, multiplies and adds rounded one by one as
// in the JAX package. act_scale_kernel first reduces max|act| per (b,
// block) (max is exact, so the scale is the same from run to run) and
// writes a_scale and 1 / a_scale; the main kernel is the float kernel with
// int8 tiles: the same 64-byte shared rows hold 64 int8 channels instead of
// 32 bf16, and mma.sync m16n8k32 (s8 x s8 -> s32) reads the fragments that
// ldmatrix gives for the same bytes. Bound on the H100: 2*valid_taps*S*C*O
// operations at the int8 rate (1979 TOPS) against 2*2*F*S*C bytes: at VSR
// L0 (k=5) 0.37 ms of operations, 0.40 ms of bytes; the pre-pass reads x
// once more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;  // BK bf16 channels (64 bytes) per K chunk
constexpr int LDS = BK + 8;  // shared row stride (bf16 elements)
constexpr int THREADS = 256;
constexpr int MAX_C = 1024;
constexpr int RED_ROWS = 128;  // partial rows one colsum_kernel block sums

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma16832(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tile(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  mma16816(c, a0, a1, a2, a3, b0, b1);
}
__device__ __forceinline__ void mma_tile(int* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  mma16832(c, a0, a1, a2, a3, b0, b1);
}

// bf16(silu_fp32(bf16(bf16(v * w) + u))) for two channels packed in a
// 32-bit word. mul.rn and add.rn name their rounding, which keeps ptxas from
// fusing them into one fma: with __hmul and __hadd it did, and that single
// rounding differed from the plain version's two in 21% of the activations
// (H100 80GB HBM3, 700 W) and, through the int8 variant's block max, moved
// whole blocks of its quantisation grid.
__device__ __forceinline__ uint32_t gn_silu2(uint32_t v, uint32_t w, uint32_t u) {
  uint32_t p, t;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(p) : "r"(v), "r"(w));
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(t) : "r"(p), "r"(u));
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t));
  const __nv_bfloat162 a = __floats2bfloat162_rn(f.x / (1.f + expf(-f.x)), f.y / (1.f + expf(-f.y)));
  return *reinterpret_cast<const uint32_t*>(&a);
}

// the pair of bf16 at p (p 4-byte aligned) as one word
__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// part1, part2: (B, F*gridDim.x, O) column partials of y and y*y, or null.
// INT8: wt holds int8 taps (k, O, C); qs (B, ceil(S/blk), 2) a_scale and
// 1/a_scale per (b, block of blk positions); wsc (O) the taps' scales.
// Two blocks an SM: the int8 variant's extra A registers would otherwise
// take it to 164 registers a thread and one block an SM.
template <bool SILU, bool INT8>
__global__ void __launch_bounds__(THREADS, 2) tconv_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wn,
    const float* __restrict__ un, const void* __restrict__ wt,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ y, float* __restrict__ part1, float* __restrict__ part2,
    const float* __restrict__ qs, const float* __restrict__ wsc, int blk, int F, int S, int C,
    int O, int K) {
  // channels per K chunk: 64 bytes of a shared row either way
  constexpr int CHUNK = INT8 ? 2 * BK : BK;
  constexpr int PIECES = CHUNK / 8;                     // 8-channel pieces of a row
  constexpr int APIECES = BM * PIECES / THREADS;        // those this thread loads
  using Acc = typename std::conditional<INT8, int, float>::type;
  __shared__ __align__(16) __nv_bfloat16 as[2][BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 bs[2][BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 wsh[MAX_C], ush[MAX_C];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn_ = warp >> 2;
  const int s0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / F, f = blockIdx.z - b * F;
  const int pad = K / 2;

  // element (b, f, s, 0) of an activation with `ch` channels
  auto at = [&](int ff, int s, int ch) -> size_t {
    return (((size_t)b * F + ff) * S + s) * ch;
  };

  if (SILU) {
    for (int c = tid; c < C; c += THREADS) {
      wsh[c] = __float2bfloat16(wn[(size_t)b * C + c]);
      ush[c] = __float2bfloat16(un[(size_t)b * C + c]);
    }
  }

  const int jlo = max(0, pad - f), jhi = min(K, F + pad - f);
  const int kchunks = C / CHUNK;
  const int n_it = (jhi - jlo) * kchunks;
  const int nblk = INT8 ? (S + blk - 1) / blk : 0;

  // this thread's 16-byte pieces of each A chunk (8 channels each); with
  // INT8, the 1/a_scale of each piece's row (rows past S quantise to 0)
  uint4 areg[APIECES];
  float ainv[APIECES];
#pragma unroll
  for (int r = 0; r < APIECES; ++r) {
    const int s = s0 + (tid + r * THREADS) / PIECES;
    ainv[r] = INT8 && s < S ? qs[((size_t)b * nblk + s / blk) * 2 + 1] : 0.f;
  }
  auto load_a = [&](int it) {
    const int j = jlo + it / kchunks, k0 = (it % kchunks) * CHUNK;
    const int fsrc = f + j - pad;
#pragma unroll
    for (int r = 0; r < APIECES; ++r) {
      const int idx = tid + r * THREADS, row = idx / PIECES, c8 = idx % PIECES;
      areg[r] = make_uint4(0, 0, 0, 0);
      if (s0 + row < S)
        areg[r] = *reinterpret_cast<const uint4*>(x + at(fsrc, s0 + row, C) + k0 + c8 * 8);
    }
  };
  auto store_a = [&](int it, int stage) {
    const int k0 = (it % kchunks) * CHUNK;
#pragma unroll
    for (int r = 0; r < APIECES; ++r) {
      const int idx = tid + r * THREADS, row = idx / PIECES, c8 = idx % PIECES;
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
      if constexpr (INT8) {
        uint32_t packed[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int qv = __float2int_rn(__fmul_rn(__bfloat162float(v[e]), ainv[r]));
          qv = min(127, max(-127, qv));
          packed[e >> 2] |= (uint32_t)(qv & 0xff) << (8 * (e & 3));
        }
        // byte c8 * 8 of the 64-byte row
        *reinterpret_cast<uint2*>(&as[stage][row * LDS + c8 * 4]) = make_uint2(packed[0], packed[1]);
      } else {
        if (s0 + row >= S) *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(&as[stage][row * LDS + c8 * 8]) = *reinterpret_cast<uint4*>(v);
      }
    }
  };
  auto load_b = [&](int it, int stage) {
    const int j = jlo + it / kchunks, k0 = (it % kchunks) * CHUNK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * THREADS, row = idx >> 2, c16 = idx & 3;  // 16-byte piece
      const size_t src = ((size_t)j * O + n0 + row) * C + k0;
      const void* p = INT8 ? static_cast<const void*>(static_cast<const int8_t*>(wt) + src + c16 * 16)
                           : static_cast<const void*>(static_cast<const __nv_bfloat16*>(wt) + src + c16 * 8);
      cp_async16(&bs[stage][row * LDS + c16 * 8], p);
    }
  };

  Acc acc[2][8][4];
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
          mma_tile(acc[mt][2 * np], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
          mma_tile(acc[mt][2 * np + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b2, b3);
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
      const float a_scale = INT8 ? qs[((size_t)b * nblk + s / blk) * 2] : 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn_ * 64 + nt * 8 + tig * 2;
        float v0, v1;
        if constexpr (INT8) {  // float(iacc) * (a_scale * w_scale) + bias, each op rounded
          v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * hr]), __fmul_rn(a_scale, wsc[col])),
                         bias[(size_t)b * O + col]);
          v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * hr + 1]),
                                   __fmul_rn(a_scale, wsc[col + 1])),
                         bias[(size_t)b * O + col + 1]);
        } else {
          v0 = acc[mt][nt][2 * hr] + bias[(size_t)b * O + col];
          v1 = acc[mt][nt][2 * hr + 1] + bias[(size_t)b * O + col + 1];
        }
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
        red[wm * BN + col] = cs1[nt][e];
        red[(4 + wm) * BN + col] = cs2[nt][e];
      }
  }
  __syncthreads();
  if (tid < BN) {
    const float a1 = ((red[tid] + red[BN + tid]) + red[2 * BN + tid]) + red[3 * BN + tid];
    const float a2 = ((red[4 * BN + tid] + red[5 * BN + tid]) + red[6 * BN + tid]) + red[7 * BN + tid];
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

long long partial_rows(int F, int S) { return (long long)F * ((S + BM - 1) / BM); }

// The main kernel, then, with a workspace ws, the statistics: the block
// partials summed RED_ROWS rows per block until one row is left, the passes
// alternating between the tail of ws and its head. Returns cudaGetLastError().
template <bool INT8>
int launch_tconv(const void* x, const void* w, const void* u, const void* wt, const void* bias,
                 const void* res, void* y, const float* qs, const float* wsc, int blk, int B,
                 int F, int S, int C, int O, int K, int silu, void* ws, void* s1, void* s2,
                 cudaStream_t st) {
  const long long p = partial_rows(F, S), n_part = (long long)B * p * O;
  float* part1 = static_cast<float*>(ws);
  float* part2 = ws ? part1 + n_part : nullptr;
  dim3 grid((S + BM - 1) / BM, O / BN, B * F);
  const auto kernel = silu ? tconv_kernel<true, INT8> : tconv_kernel<false, INT8>;
  kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(u), wt, static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res), static_cast<__nv_bfloat16*>(y), part1, part2, qs,
      wsc, blk, F, S, C, O, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return (int)err;

  float* tail = part1 + 2 * n_part;
  const float *src1 = part1, *src2 = part2;
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
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return (int)err;
    src1 = dst1;
    src2 = dst2;
    rows = chunks;
    to_tail = !to_tail;
  }
}

bool bad_shape(int B, int F, int S, int C, int O, int K, int chunk, void* ws, void* s1, void* s2) {
  return B < 1 || F < 1 || S < 1 || C % chunk || C > MAX_C || O % BN || K % 2 == 0 || K > 7 ||
         (long long)B * F > 65535 || O / BN > 65535 ||
         (ws != nullptr && (s1 == nullptr || s2 == nullptr));
}

}  // namespace

// Floats of scratch that gn_silu_tconv_bf16 needs to emit statistics.
extern "C" long long gn_silu_tconv_workspace_floats(int B, int F, int S, int O) {
  const long long p = partial_rows(F, S);
  return 2LL * B * O * (p + (p + RED_ROWS - 1) / RED_ROWS);
}

// x (B,F,S,C); res and y (B,F,S,O); w, u (B,C) fp32, not read when silu is
// 0; wt (k,O,C) bf16; bias (B,O) fp32; res may be null. With a workspace ws
// of gn_silu_tconv_workspace_floats floats, s1 and s2 (B,O) fp32 receive the
// sums over (F, S) of y and y*y; ws null emits nothing. Requires C % 32 == 0,
// C <= 1024, O % 128 == 0, odd k <= 7, contiguous 16-byte aligned tensors.
// Returns cudaGetLastError().
extern "C" int gn_silu_tconv_bf16(const void* x, const void* w, const void* u, const void* wt,
                                  const void* bias, const void* res, void* y, int B, int F, int S,
                                  int C, int O, int K, int silu, void* ws, void* s1, void* s2,
                                  void* stream) {
  if (bad_shape(B, F, S, C, O, K, BK, ws, s1, s2)) return (int)cudaErrorInvalidValue;
  return launch_tconv<false>(x, w, u, wt, bias, res, y, nullptr, nullptr, 1, B, F, S, C, O, K,
                             silu, ws, s1, s2, static_cast<cudaStream_t>(stream));
}

// The int8 variant: as gn_silu_tconv_bf16, with wq (k,O,C) int8 taps and
// wsc (O) fp32 their per-output-channel scales; blk positions share one
// activation scale; qs, scratch of B * ceil(S / blk) * 2 floats, receives
// (a_scale, 1 / a_scale) per block. Requires C % 64 == 0.
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
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_tconv<true>(x, w, u, wq, bias, res, y, static_cast<const float*>(qs),
                            static_cast<const float*>(wsc), blk, B, F, S, C, O, K, silu, ws, s1,
                            s2, st);
}
