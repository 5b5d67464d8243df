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
// act, rounded to bf16 (silu in the TPU body's order, as the float path), is
// quantised with one symmetric scale per (batch, block of `blk` positions)
// shared by all F frames, a_scale = max(max|act|, 1e-12) / 127, q =
// clamp(rn(act * (1 / a_scale)), +-127); the taps arrive quantised per
// output channel (w_scale, by the wrapper); the k taps accumulate in int32
// and y = float(iacc) * (a_scale * w_scale[o]) + bias (+ res), rounded to
// bf16, the conversion, multiplies and adds rounded one by one as in the
// JAX package. Bound on the H100: 2*valid_taps*S*C*O operations at the int8
// rate (1979 TOPS) against 2*2*F*S*C bytes: at VSR up 2 (S = 163840, C = O
// = 512, k = 5) 1.48 ms of operations. Its design, three steps on the
// float path's pieces:
//   act_absmax_kernel: max|act| over pieces of `piece_rows` positions of
//     one frame and one scale block, so the pass spreads over the card at
//     every size (the plan keeps at least two blocks an SM); act_scale_kernel
//     then takes the max of each (b, scale block)'s pieces and writes a_scale
//     and 1 / a_scale (max is exact: the same scales from run to run).
//   act_quant_kernel activates each element once more and stores q into an
//     int8 scratch (B, F, S, C) that the wrapper allocates: 5 bytes of HBM an
//     element with the pass above, against 7 to store the activation.
//   tconv_int8_gemm_kernel<BN>: the float GEMM's implicit GEMM on wgmma
//     m64nBNk32 s8 x s8 -> s32, fed by the same TMA ring: a 128-byte swizzled
//     row holds 128 int8 channels where it held 64 bf16, so a ring stage
//     and a 32-byte k-step are the float kernel's in bytes; A by a 4-D uint8
//     map over the scratch as (C, S, F, B), zero past C and S; the taps by a
//     2-D map over (k * O, C). The epilogue dequantises with each row's
//     a_scale (looked up per position, so any blk works) and each column's
//     w_scale, adds bias and residual, rounds once and stores by TMA from
//     the staging box, whose statistics colsum_kernel finishes as above.

#include <stdint.h>

#include <type_traits>

#include "wgmma_gemm.cuh"

namespace {

using namespace wgemm;

constexpr int INT8_SLAB = 128;  // int8 channels in a 128-byte swizzled row
constexpr int MAX_C = 1024;
constexpr int RED_ROWS = 128;  // partial rows one colsum_kernel block sums

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

// the activation of both kernels, in the TPU body's order:
// bf16(t * (1 / (1 + e^-t))) of the affine (lavie_tpu/kernels/temporal_resblock.py::_silu)
__device__ __forceinline__ uint32_t gn_silu2_tpu(uint32_t v, uint32_t w, uint32_t u) {
  const float2 f = gn_affine2(v, w, u);
  return pack_bf16(__fmul_rn(f.x, __frcp_rn(1.f + expf(-f.x))),
                   __fmul_rn(f.y, __frcp_rn(1.f + expf(-f.y))));
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

// w and u of channels c.. c+7 of one batch row (wn, un + off: 8 fp32 each)
// as the bf16 pairs the TPU body multiplies and adds
__device__ __forceinline__ void load_affine(const float* wn, const float* un, size_t off,
                                            uint32_t (&w)[4], uint32_t (&u)[4]) {
  const float4 w0 = *reinterpret_cast<const float4*>(wn + off);
  const float4 w1 = *reinterpret_cast<const float4*>(wn + off + 4);
  const float4 u0 = *reinterpret_cast<const float4*>(un + off);
  const float4 u1 = *reinterpret_cast<const float4*>(un + off + 4);
  w[0] = pack_bf16(w0.x, w0.y), w[1] = pack_bf16(w0.z, w0.w);
  w[2] = pack_bf16(w1.x, w1.y), w[3] = pack_bf16(w1.z, w1.w);
  u[0] = pack_bf16(u0.x, u0.y), u[1] = pack_bf16(u0.z, u0.w);
  u[2] = pack_bf16(u1.x, u1.y), u[3] = pack_bf16(u1.z, u1.w);
}

// the activation of 8 channels (16 bytes of x)
__device__ __forceinline__ uint4 activate8(uint4 v, const uint32_t (&w)[4], const uint32_t (&u)[4]) {
  v.x = gn_silu2_tpu(v.x, w[0], u[0]);
  v.y = gn_silu2_tpu(v.y, w[1], u[1]);
  v.z = gn_silu2_tpu(v.z, w[2], u[2]);
  v.w = gn_silu2_tpu(v.w, w[3], u[3]);
  return v;
}

// ---- the int8 path: scales, quantisation, implicit GEMM on s8 wgmma -------

// The int8 passes' thread layout: thread t of 256 takes the 8 channels
// (16 bytes of x) of group t % (C / 8) of every `per` = 256 / (C / 8)-th row
// (threads past per * C / 8 idle), so its w and u stay in registers and no
// index needs a division by anything but a row count.
struct RowThread {
  int cg, r0, per;  // channel group, first row offset, rows a step (0: idle)
};
__device__ __forceinline__ RowThread row_thread(int C) {
  const int c8s = C / 8, per = 256 / c8s;
  const int r0 = threadIdx.x / c8s;
  return RowThread{(int)threadIdx.x - r0 * c8s, r0 < per ? r0 : 0, r0 < per ? per : 0};
}

// the max of m over the block's 256 threads, in thread 0
__device__ __forceinline__ float block_max(float m) {
  __shared__ float red[8];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w]);
  return m;
}

// amax[((b * nblk + i) * F + f) * pieces + p] = max |act| over positions
// i * blk + p * piece_rows .. (at most piece_rows, inside block i and S) of
// frame f and all C channels, act as bf16 (0 for an empty piece). Grid
// (nblk * pieces, F, B).
template <bool SILU>
__global__ void __launch_bounds__(256) act_absmax_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wn, const float* __restrict__ un,
    float* __restrict__ amax, int S, int C, int blk, int piece_rows, int pieces) {
  const int i = blockIdx.x / pieces, p = blockIdx.x - i * pieces, f = blockIdx.y, b = blockIdx.z;
  const int lo = i * blk + p * piece_rows, hi = min(min(lo + piece_rows, (i + 1) * blk), S);
  const RowThread rt = row_thread(C);
  const int c8s = C / 8;
  uint32_t w[4], u[4];
  if (SILU) load_affine(wn, un, (size_t)b * C + rt.cg * 8, w, u);
  const uint4* src = reinterpret_cast<const uint4*>(x + (((size_t)b * gridDim.y + f) * S) * C);
  float m = 0.f;
  if (rt.per > 0) {
    for (int r = lo + rt.r0; r < hi; r += rt.per) {
      uint4 v = src[(size_t)r * c8s + rt.cg];
      if (SILU) v = activate8(v, w, u);
      const uint32_t* vp = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vp + q));
        m = fmaxf(m, fmaxf(fabsf(a.x), fabsf(a.y)));
      }
    }
  }
  m = block_max(m);
  if (threadIdx.x == 0)
    amax[blockIdx.z * (size_t)gridDim.x * gridDim.y + (size_t)i * gridDim.y * pieces + f * pieces + p] = m;
}

// qs[b, i] = (a_scale, 1 / a_scale) of scale block i of batch row b, from
// the `parts` = F * pieces partial maxima of act_absmax_kernel. Grid (nblk, B).
__global__ void __launch_bounds__(256) act_scale_kernel(const float* __restrict__ amax,
                                                        float* __restrict__ qs, int parts) {
  const size_t blk_id = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const float* src = amax + blk_id * parts;
  float m = 0.f;
  for (int e = threadIdx.x; e < parts; e += blockDim.x) m = fmaxf(m, src[e]);
  m = block_max(m);
  if (threadIdx.x == 0) {
    const float a_scale = fmaxf(m, 1e-12f) / 127.f;
    qs[blk_id * 2] = a_scale;
    qs[blk_id * 2 + 1] = 1.f / a_scale;
  }
}

// aq = clamp(rn(act * (1 / a_scale)), +-127) as int8 over the `rows` = B *
// F * S rows of x, 8 channels (16 bytes of x, 8 of aq) a thread a row; the
// scale of position s is its block s / blk's.
template <bool SILU>
__global__ void __launch_bounds__(256) act_quant_kernel(
    const uint4* __restrict__ x, const float* __restrict__ wn, const float* __restrict__ un,
    const float* __restrict__ qs, uint2* __restrict__ aq, int rows, int F, int S, int C, int blk,
    int nblk) {
  const RowThread rt = row_thread(C);
  if (rt.per == 0) return;
  const int c8s = C / 8;
  uint32_t w[4], u[4];
  int wb = -1;  // the batch row whose w and u are loaded
  for (int row = blockIdx.x * rt.per + rt.r0; row < rows; row += gridDim.x * rt.per) {
    const int fr = row / S, s = row - fr * S, b = fr / F;
    if (SILU && b != wb) {
      load_affine(wn, un, (size_t)b * C + rt.cg * 8, w, u);
      wb = b;
    }
    const size_t e = (size_t)row * c8s + rt.cg;
    uint4 v = x[e];
    if (SILU) v = activate8(v, w, u);
    const float inv = qs[((size_t)b * nblk + s / blk) * 2 + 1];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int qv = min(127, max(-127, __float2int_rn(__fmul_rn(__bfloat162float(h[q]), inv))));
      packed[q >> 2] |= (uint32_t)(qv & 0xff) << (8 * (q & 3));
    }
    aq[e] = make_uint2(packed[0], packed[1]);
  }
}

// ---- the float path's activation pass; the implicit GEMM of both paths ----

constexpr int CONV_STAGES_MAX = 6;
constexpr int STAGING_ROWS = 64;  // a consumer warpgroup's rows of the output tile

// act = the activated x, 8 channels (16 bytes) a thread a step
__global__ void __launch_bounds__(256) tconv_act_kernel(const uint4* __restrict__ x,
                                                        const float* __restrict__ wn,
                                                        const float* __restrict__ un,
                                                        uint4* __restrict__ act, long long n8,
                                                        long long per_batch8, int C) {
  const int c8s = C / 8;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t w[4], u[4];
    load_affine(wn, un, (size_t)(i / per_batch8) * C + (i % c8s) * 8, w, u);
    act[i] = activate8(x[i], w, u);
  }
}

struct ConvArgs {
  const float* bias;    // (B, O)
  float *part1, *part2;  // (B, F*2*s_tiles, O) column partials of y and y*y, or null
  const float* qs;       // int8: (B, nblk, 2) a_scale, 1 / a_scale per scale block
  const float* wsc;      // int8: (O) the taps' scales
  int blk, nblk;         // int8: positions a scale block, blocks a batch row
  int F, S, O, K;
  int c_blocks;  // 64-channel (int8: 128-channel) slabs of K a tap
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
// each slab of C (64 bf16 or 128 int8 channels: 128 bytes), one ring stage:
// the A slab (128 positions of the source frame) and the tap's B slab (BN
// output channels).
template <int BN, bool INT8>
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
        const int c0 = kb * (INT8 ? INT8_SLAB : SLAB);
        tma_load_4d(sa, tm_x, full, c0, ct.s0, ct.f + j - pad, ct.b);
        tma_load_2d(sa + A_BYTES, tm_w, full, c0, j * a.O + ct.n0);
      }
  }
}

// The implicit GEMM's body. Shared memory: the ring, two staging boxes (one
// a consumer warpgroup: BN / 64 swizzled slabs of 64 rows), the ring's
// barriers and one residual barrier a consumer warpgroup. INT8: s8 products
// into s32, dequantised in the epilogue.
template <int BN, bool INT8>
__device__ __forceinline__ void conv_gemm(const CUtensorMap* tm_x, const CUtensorMap* tm_w,
                                          const CUtensorMap* tm_y, const CUtensorMap* tm_res,
                                          const ConvArgs& a) {
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
    if (threadIdx.x == 0) conv_produce<BN, INT8>(tm_x, tm_w, a, ring, bars);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, tw = threadIdx.x - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31, g8 = lane >> 2, tig = lane & 3;
  const uint32_t box = staging + c * SLABS * BOX, res_bar = bars + 16 * MAX_STAGES + 8 * c;
  typename std::conditional<INT8, int, float>::type acc[BN / 2];
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
        for (int q = 0; q < SLABS; ++q) tma_load_4d(box + q * BOX, tm_res, res_bar, ct.n0 + q * SLAB, r0, ct.f, ct.b);
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
    // slab j / 8 of the box. INT8: float(iacc) * (a_scale * w_scale) + bias,
    // each op rounded, a_scale that of the row's position (rows past S are
    // not stored)
    const float* bb = a.bias + (size_t)ct.b * a.O + ct.n0;
    float a_scale[2] = {0.f, 0.f};
    if constexpr (INT8) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = r0 + warp * 16 + g8 + 8 * h;
        if (s < a.S) a_scale[h] = a.qs[((size_t)ct.b * a.nblk + s / a.blk) * 2];
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 bv = bias2(bb + 8 * j + 2 * tig);
      float2 ws = make_float2(0.f, 0.f);
      if constexpr (INT8) ws = *reinterpret_cast<const float2*>(a.wsc + ct.n0 + 8 * j + 2 * tig);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t addr = box + (j / 8) * BOX + swizzled(warp * 16 + g8 + 8 * h, j % 8) + tig * 4;
        float v0, v1;
        if constexpr (INT8) {
          v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), __fmul_rn(a_scale[h], ws.x)), bv.x);
          v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), __fmul_rn(a_scale[h], ws.y)),
                         bv.y);
        } else {
          v0 = acc[4 * j + 2 * h] + bv.x;
          v1 = acc[4 * j + 2 * h + 1] + bv.y;
        }
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
      for (int q = 0; q < SLABS; ++q) tma_store_4d(tm_y, box + q * BOX, ct.n0 + q * SLAB, r0, ct.f, ct.b);
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

// the float GEMM, on the activated input (or x)
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) tconv_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_res,
    const ConvArgs a) {
  conv_gemm<BN, false>(&tm_x, &tm_w, &tm_y, &tm_res, a);
}

// the int8 GEMM, on the quantised input and taps
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) tconv_int8_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_res,
    const ConvArgs a) {
  conv_gemm<BN, true>(&tm_x, &tm_w, &tm_y, &tm_res, a);
}

// the GEMM's shared bytes: ring, staging boxes, barriers
int conv_smem(int bn, int stages) {
  return ring_smem(stages, (BM + bn) * ROW_BYTES, 2 * bn * STAGING_ROWS * 2 + 16);
}

template <int BN, bool INT8>
cudaError_t launch_conv(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
                        const CUtensorMap& mr, const ConvArgs& a, int grid, cudaStream_t st) {
  const auto kernel = INT8 ? tconv_int8_gemm_kernel<BN> : tconv_gemm_kernel<BN>;
  const int smem = conv_smem(BN, a.stages);
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid < a.tiles ? grid : a.tiles, THREADS, smem, st>>>(mx, mw, my, mr, a);
  return cudaGetLastError();
}


// partial rows of the statistics per batch row: one per (frame, 64 positions)
long long partial_rows(int F, int S) { return (long long)F * 2 * ((S + BM - 1) / BM); }

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

bool bad_plan(int O, int bn, int stages, int grid) {
  return (bn != 128 && bn != 256) || O % bn || stages < 2 || stages > CONV_STAGES_MAX || grid < 1 ||
         conv_smem(bn, stages) > SMEM_LIMIT;
}

// The implicit GEMM over the A operand a_src (B, F, S, C): bf16, or int8
// dequantised by qs (per block of blk positions, nblk a batch row) and wsc
// (per output channel); then the statistics.
template <bool INT8>
int run_gemm(const void* a_src, const void* wt, const void* bias, const void* res, void* y,
             void* ws, void* s1, void* s2, int B, int F, int S, int C, int O, int K, int bn,
             int stages, int grid, const float* qs, const float* wsc, int blk, int nblk,
             cudaStream_t st) {
  const int eb = INT8 ? 1 : 2;
  CUtensorMap m_x, m_w, m_y, m_r;
  if (!make_map_4d(&m_x, a_src, C, S, F, B, BM, eb) || !make_map_2d(&m_w, wt, C, K * O, bn, eb) ||
      !make_map_4d(&m_y, y, O, S, F, B, STAGING_ROWS) ||
      !make_map_4d(&m_r, res != nullptr ? res : y, O, S, F, B, STAGING_ROWS))
    return (int)cudaErrorNotSupported;
  const long long p = partial_rows(F, S), n_part = (long long)B * p * O;
  float* part1 = static_cast<float*>(ws);
  const int s_tiles = (S + BM - 1) / BM, slab = INT8 ? INT8_SLAB : SLAB;
  const long long tiles = (long long)B * s_tiles * F * (O / bn);
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const ConvArgs a{static_cast<const float*>(bias), part1, part1 ? part1 + n_part : nullptr,
                   qs, wsc, blk, nblk, F, S, O, K, (C + slab - 1) / slab, s_tiles, O / bn,
                   (int)tiles, stages, res != nullptr};
  const cudaError_t err = bn == 256 ? launch_conv<256, INT8>(m_x, m_w, m_y, m_r, a, grid, st)
                                    : launch_conv<128, INT8>(m_x, m_w, m_y, m_r, a, grid, st);
  if (err != cudaSuccess || ws == nullptr) return (int)err;
  return column_sums(part1, p, B, O, s1, s2, st);
}

}  // namespace

// Floats of scratch that gn_silu_tconv_bf16 and gn_silu_tconv_int8_bf16 need
// to emit statistics.
extern "C" long long gn_silu_tconv_workspace_floats(int B, int F, int S, int O) {
  const long long p = partial_rows(F, S);
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
  if (bad_shape(B, F, S, C, O, K, 32, ws, s1, s2) || bad_plan(O, bn, stages, grid) ||
      (silu && act == nullptr))
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
  return run_gemm<false>(a_src, wt, bias, res, y, ws, s1, s2, B, F, S, C, O, K, bn, stages, grid,
                         nullptr, nullptr, 0, 0, st);
}

// The int8 variant: as gn_silu_tconv_bf16 with wq (k,O,C) int8 taps and wsc
// (O) fp32 their per-output-channel scales; blk positions share one
// activation scale. Scratch: aq (B,F,S,C) int8 for the quantised input,
// amax of B * nblk * F * pieces floats for the partial maxima (nblk =
// ceil(S / blk), pieces = ceil(blk / piece_rows)), qs of B * nblk * 2 floats
// for (a_scale, 1 / a_scale) per scale block. The launch plan
// (kernels/temporal_resblock.py::int8_launch_plan): piece_rows, and the
// GEMM's bn, stages and grid. Four kernels in three steps (the scales, the
// int8 input, the GEMM), then the statistics. Requires C % 64 == 0.
extern "C" int gn_silu_tconv_int8_bf16(const void* x, const void* w, const void* u, const void* wq,
                                       const void* wsc, const void* bias, const void* res, void* y,
                                       void* aq, void* amax, void* qs, void* ws, void* s1, void* s2,
                                       int B, int F, int S, int C, int O, int K, int silu, int blk,
                                       int piece_rows, int bn, int stages, int grid, void* stream) {
  if (bad_shape(B, F, S, C, O, K, 64, ws, s1, s2) || bad_plan(O, bn, stages, grid) || blk < 1 ||
      piece_rows < 1 || aq == nullptr || amax == nullptr || qs == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (S + blk - 1) / blk, pieces = (blk + piece_rows - 1) / piece_rows;
  if ((long long)nblk * pieces > 0x7fffffffLL || B > 65535 || (long long)B * F * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto *wf = static_cast<const float*>(w), *uf = static_cast<const float*>(u);
  float *am = static_cast<float*>(amax), *q = static_cast<float*>(qs);
  // 1. the scales: partial maxima over the card, then one block a scale block
  const auto absmax = silu ? act_absmax_kernel<true> : act_absmax_kernel<false>;
  absmax<<<dim3(nblk * pieces, F, B), 256, 0, st>>>(xb, wf, uf, am, S, C, blk, piece_rows, pieces);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  act_scale_kernel<<<dim3(nblk, B), 256, 0, st>>>(am, q, F * pieces);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 2. the int8 input
  const int rows = B * F * S, per = 256 / (C / 8);
  const long long blocks = (rows + per - 1) / per, cap = 16LL * sm_count();
  const auto quant = silu ? act_quant_kernel<true> : act_quant_kernel<false>;
  quant<<<(unsigned)(blocks < cap ? blocks : cap), 256, 0, st>>>(
      static_cast<const uint4*>(x), wf, uf, q, static_cast<uint2*>(aq), rows, F, S, C, blk, nblk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 3. the GEMM (and the statistics)
  return run_gemm<true>(aq, wq, bias, res, y, ws, s1, s2, B, F, S, C, O, K, bn, stages, grid, q,
                        static_cast<const float*>(wsc), blk, nblk, st);
}
