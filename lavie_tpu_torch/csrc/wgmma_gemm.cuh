// Persistent, warp-specialised wgmma GEMMs fed by a TMA ring, shared by the
// kernels whose products are row-tile GEMMs against nn.Linear weights
// (geglu.cu, transformer_tail.cu) and by the implicit-GEMM temporal conv
// (temporal_resblock.cu):
//   - warpgroup 0 produces: one thread keeps a ring of stages of TMA loads
//     in flight, each stage the A tile's 64-column slab (BM rows) and the B
//     slab (BN weight rows), both K-major in 128-byte swizzled boxes;
//   - warpgroups 1 and 2 consume with wgmma, both operands from shared
//     memory, either taking turns on whole tiles (ping-pong: one
//     warpgroup's epilogue runs under the other's products) or both on each
//     tile, 64 rows each (cooperative, at BN = 256: one m64n256 accumulator
//     a warpgroup);
//   - the gate epilogue (x W0h^T + b0h) * gelu_erf(x W0g^T + b0g) leaves by
//     TMA from a swizzled staging box; the out epilogue adds a bias, and
//     optionally a bf16 residual after the first rounding, and stores from
//     registers, or (F32) stores its fp32 products with no bias;
//   - the staged cooperative GEMM (the VSR only-cross head's five GEMMs,
//     ln_qkv's q/k/v projections) adds an fp32 bias (and a residual loaded
//     by TMA), scales by an fp32 factor or only rounds, and leaves by TMA
//     from staging boxes;
//   - the cooperative consumers' products run on bf16 into fp32 or, for the
//     int8 temporal conv, on s8 into s32 (the same 128-byte rows: 64 bf16
//     or 128 int8 channels, one 32-byte k-step a wgmma).
// Each kernel that instantiates them is a __global__ of its own source, so
// that a profile tells the callers apart. The bias is bf16 (GEGLU) or fp32
// (the transformer tail, the head), as the TPU bodies take them.

#pragma once

#include "hopper.cuh"

namespace wgemm {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BM = 128;          // rows of a tile
constexpr int THREADS = 384;     // warpgroup 0 produces, 1 and 2 consume
constexpr int GATE_COLS = 64;    // act columns of a gate tile: 64 hidden, 64 gate rows of W0
constexpr int A_BYTES = BM * ROW_BYTES;  // one 64-column slab of an A tile
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;

struct GemmArgs {
  const void* bias;  // b0 (2I) or b2 (C), bf16 or fp32
  bf16* out;         // act (rows, I) or y (rows, C)
  int rows;          // rows of A and of the output
  int ldo;           // the output's row stride: I or C
  int k_blocks;      // K / 64
  int col_tiles;     // output column tiles a row tile
  int stages;
  int inner;         // I: the gate rows' offset in W0 and b0
  const bf16* res;   // the out epilogue's residual (rows, ldo), or null
  float scale;       // the staged GEMM's EPI_SCALE factor
  float* out_f32;    // the F32 out epilogue's output (rows, ldo) in place of out
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two adjacent bias values as fp32
__device__ __forceinline__ float2 bias2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 bias2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// bytes of one ring stage: the A slab and a B slab of BN rows
template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + BN * ROW_BYTES;
}

// gelu_erf(x) = x/2 (1 + erf(x / sqrt 2)) with the TPU body's own erf
// (lavie_tpu/kernels/geglu.py::_erf, Abramowitz-Stegun 7.1.26, |error| <
// 1.5e-7): erf(z) = sign(z) (1 - t P(t) exp(-z^2)), t = 1 / (1 + p|z|), so
// gelu_erf(x) = (x + |x| (1 - t P(t) exp(-x^2 / 2))) / 2. Branch-free, one
// reciprocal and one exponential on the special-function unit: the gate
// GEMM's epilogue evaluates 8192 of them a tile.
__device__ __forceinline__ float gelu_erf(float x) {
  const float ax = fabsf(x);
  float t;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(t) : "f"(fmaf(0.3275911f * 0.70710678118654752f, ax, 1.f)));
  const float poly =
      t * fmaf(fmaf(fmaf(fmaf(1.061405429f, t, -1.453152027f), t, 1.421413741f), t, -0.284496736f), t,
               0.254829592f);
  const float e = ex2(x * x * -0.72134752044448170f);  // exp(-x^2 / 2)
  return 0.5f * (x + ax * (1.f - poly * e));
}

// The block's k-th tile is t = blockIdx.x + k * gridDim.x; tiles walk the
// columns fastest. (row0, ct) of it.
__device__ __forceinline__ int2 tile_at(const GemmArgs& a, int k) {
  const int t = blockIdx.x + k * gridDim.x;
  return make_int2((t / a.col_tiles) * BM, t % a.col_tiles);
}

// the number of tiles of this block
__device__ __forceinline__ int block_tiles(const GemmArgs& a) {
  const int tiles = (a.rows + BM - 1) / BM * a.col_tiles;
  return (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
}

// Output column tile ct of GROUPS groups of col_tiles / GROUPS tiles each,
// one B map and one output map a group: (group, tile within it).
template <int GROUPS>
__device__ __forceinline__ int2 group_tile(int ct, int col_tiles) {
  if constexpr (GROUPS == 1) {
    return make_int2(0, ct);
  } else {
    const int per = col_tiles / GROUPS;
    return make_int2(ct / per, ct % per);
  }
}

// The producer thread: for each of the block's tiles and each 64-column
// slab of K, one ring stage: the A slab (BM rows) and the B slab. GATE: B is
// W0's 64 hidden rows of the tile's columns, then the 64 gate rows I + those
// columns; else BN rows of W2 (of the tile's group's map in tm_b[GROUPS]).
template <int BN, bool GATE, int GROUPS = 1>
__device__ __forceinline__ void produce(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                        const GemmArgs& a, uint32_t ring, uint32_t bars) {
  constexpr int STAGE = stage_bytes<BN>();
  const int tiles = block_tiles(a);
  int g = 0;  // stages issued by this block
  for (int k = 0; k < tiles; ++k) {
    const int2 tc = tile_at(a, k);
    for (int kb = 0; kb < a.k_blocks; ++kb, ++g) {
      const int s = g % a.stages;
      if (g >= a.stages) mbar_wait(bars + 8 * (MAX_STAGES + s), ((g / a.stages) - 1) & 1);
      const uint32_t full = bars + 8 * s, sa = ring + s * STAGE, sb = sa + A_BYTES;
      mbar_expect_tx(full, STAGE);
      tma_load_2d(sa, tm_a, full, kb * SLAB, tc.x);
      if constexpr (GATE) {
        tma_load_2d(sb, tm_b, full, kb * SLAB, tc.y * GATE_COLS);
        tma_load_2d(sb + GATE_COLS * ROW_BYTES, tm_b, full, kb * SLAB, a.inner + tc.y * GATE_COLS);
      } else {
        const int2 gt = group_tile<GROUPS>(tc.y, a.col_tiles);
        tma_load_2d(sb, tm_b + gt.x, full, kb * SLAB, gt.y * BN);
      }
    }
  }
}

__device__ __forceinline__ void init_ring(uint32_t bars, int stages, int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);                        // full: the stage's bytes arrived
      mbar_init(bars + 8 * (MAX_STAGES + s), consumers);  // empty: its readers are done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The out epilogue of one thread's 16-row band: y = bf16(acc + bias), or
// with RES y = bf16(bf16(acc + bias) + res) (the bf16 residual added after
// the first rounding, as the TPU body adds it), or with F32 y = acc in fp32
// into a.out_f32, no bias (a tensor-parallel shard's partial product, summed
// over the ranks before its bias and one rounding); rows past a.rows are
// not stored. acc[4j + e] is row r0 + 8 * (e / 2), column 8j + 2 * tig +
// e % 2 of the tile, whose first column is c0.
template <int BN, typename BiasT, bool RES, bool F32 = false>
__device__ __forceinline__ void store_rows(const GemmArgs& a, const float (&acc)[BN / 2], int r0,
                                           int c0, int tig) {
  if constexpr (F32) {
    float* f0 = a.out_f32 + (size_t)r0 * a.ldo + c0;
    float* f1 = f0 + (size_t)8 * a.ldo;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      if (r0 < a.rows) *reinterpret_cast<float2*>(f0 + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (r0 + 8 < a.rows)
        *reinterpret_cast<float2*>(f1 + col) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    return;
  }
  const BiasT* bb = static_cast<const BiasT*>(a.bias) + c0;
  bf16* o0 = a.out + (size_t)r0 * a.ldo + c0;
  bf16* o1 = o0 + (size_t)8 * a.ldo;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    const float2 bv = bias2(bb + col);
    __nv_bfloat162 v0 = __floats2bfloat162_rn(acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
    __nv_bfloat162 v1 = __floats2bfloat162_rn(acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
    if constexpr (RES) {
      const bf16* q0 = a.res + (size_t)r0 * a.ldo + c0 + col;
      if (r0 < a.rows) v0 = __hadd2(v0, *reinterpret_cast<const __nv_bfloat162*>(q0));
      if (r0 + 8 < a.rows)
        v1 = __hadd2(v1, *reinterpret_cast<const __nv_bfloat162*>(q0 + (size_t)8 * a.ldo));
    }
    if (r0 < a.rows) *reinterpret_cast<__nv_bfloat162*>(o0 + col) = v0;
    if (r0 + 8 < a.rows) *reinterpret_cast<__nv_bfloat162*>(o1 + col) = v1;
  }
}

// A ping-pong GEMM: tiles of 128 rows by BN B columns, each consumer
// warpgroup owning whole tiles, the block's even ones or its odd ones, so
// that one warpgroup's epilogue runs while the other issues its products:
// two m64nBNk16 wgmma a k-step, for rows 0-63 and 64-127. Named barriers 3
// and 4 hand the tensor cores from one warpgroup to the other after each
// tile's last k-block.
// GATE, the gate GEMM: act = bf16((x W0h^T + b0h) * gelu_erf(x W0g^T + b0g)),
//   a tile 64 act columns, BN = 128: B columns 0-63 are the hidden and 64-127
//   the gate of the same act columns, in the same thread. The act tile
//   leaves through the warpgroup's 16 KB staging box in shared memory, laid
//   out as the 128-byte swizzled TMA box, by one TMA store.
// else the out GEMM: y = bf16(act W2^T + b2) (+ res) at BN = 128 or 160,
//   where its epilogue (a bias add, one rounding, stores from registers)
//   would leave the tensor cores idle.
// The body of a __global__ of THREADS threads, one block an SM.
template <int BN, bool GATE, typename BiasT, bool RES, bool F32 = false>
__device__ __forceinline__ void pingpong_gemm(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                              const CUtensorMap* tm_act, const GemmArgs& a) {
  constexpr int STAGE = stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;  // the swizzle atom is 1024 bytes
  const uint32_t staging = ring + a.stages * STAGE;  // GATE: one act box a consumer warpgroup
  const uint32_t bars = staging + (GATE ? 2 * A_BYTES : 0);
  const int tiles = block_tiles(a);
  init_ring(bars, a.stages, 128);  // a stage is read by the one warpgroup of its tile

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) produce<BN, GATE>(tm_a, tm_b, a, ring, bars);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, tw = threadIdx.x - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31, g8 = lane >> 2, tig = lane & 3;
  const uint32_t box = staging + c * A_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  float acc0[BN / 2], acc1[BN / 2];  // rows 0-63 and 64-127 of the tile
  for (int k = c; k < tiles; k += 2) {  // the block's k-th tile
    const int2 tc = tile_at(a, k);
    const int row0 = tc.x, ct = tc.y;
    int g = k * a.k_blocks;  // the tile's first stage
    if (k > 0) asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c));  // tile k-1 is issued
    int s = g % a.stages;
    mbar_wait(full(s), (g / a.stages) & 1);
    {
      const uint32_t sa = ring + s * STAGE, sb = sa + A_BYTES;
      fence_regs<BN / 2>(acc0);
      fence_regs<BN / 2>(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Gmma<BN>::ss(acc0, gmma_desc(sa + kk * 32), gmma_desc(sb + kk * 32), kk > 0);
        Gmma<BN>::ss(acc1, gmma_desc(sa + 64 * ROW_BYTES + kk * 32), gmma_desc(sb + kk * 32), kk > 0);
      }
      wgmma_commit();
      fence_regs<BN / 2>(acc0);
      fence_regs<BN / 2>(acc1);
    }
    int prev = s;
    ++g;
    for (int kb = 1; kb < a.k_blocks; ++kb, ++g) {
      s = g % a.stages;
      mbar_wait(full(s), (g / a.stages) & 1);
      const uint32_t sa = ring + s * STAGE, sb = sa + A_BYTES;
      fence_regs<BN / 2>(acc0);
      fence_regs<BN / 2>(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Gmma<BN>::ss(acc0, gmma_desc(sa + kk * 32), gmma_desc(sb + kk * 32), 1);
        Gmma<BN>::ss(acc1, gmma_desc(sa + 64 * ROW_BYTES + kk * 32), gmma_desc(sb + kk * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-block's products are done with its stage
      fence_regs<BN / 2>(acc0);
      fence_regs<BN / 2>(acc1);
      mbar_arrive(empty(prev));
      prev = s;
    }
    // the other warpgroup may issue tile k + 1 while these products finish
    if (k + 1 < tiles) asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c));
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc0);
    fence_regs<BN / 2>(acc1);
    mbar_arrive(empty(prev));

    // epilogue: acc[4j + e] is row g8 + 8 * (e / 2) of this warp's 16,
    // B column 8j + 2 * tig + e % 2
    if constexpr (GATE) {
      // hidden for j < 8, gate for j >= 8; act column 8j + 2 * tig goes to
      // 16-byte chunk j of its row in the box
      if (tw == 0) tma_store_wait_read<0>();  // the previous tile's store has read the box
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c));
      const BiasT* bh = static_cast<const BiasT*>(a.bias) + ct * GATE_COLS;
      const BiasT* bg = bh + a.inner;
      auto epilogue = [&](const float (&acc)[BN / 2], int r) {
#pragma unroll
        for (int j = 0; j < GATE_COLS / 8; ++j) {
          const int col = 8 * j + 2 * tig;
          const float2 hb = bias2(bh + col);
          const float2 gb = bias2(bg + col);
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = (acc[4 * j + e] + (e & 1 ? hb.y : hb.x)) *
                   gelu_erf(acc[BN / 4 + 4 * j + e] + (e & 1 ? gb.y : gb.x));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(box + swizzled(r, j) + tig * 4),
                       "r"(pack_bf16(v[0], v[1])));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(box + swizzled(r + 8, j) + tig * 4),
                       "r"(pack_bf16(v[2], v[3])));
        }
      };
      epilogue(acc0, warp * 16 + g8);
      epilogue(acc1, 64 + warp * 16 + g8);
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c));
      if (tw == 0) {  // rows past the end are not written
        tma_store_2d(tm_act, box, ct * GATE_COLS, row0);
        tma_store_commit();
      }
    } else {
      store_rows<BN, BiasT, RES, F32>(a, acc0, row0 + warp * 16 + g8, ct * BN, tig);
      store_rows<BN, BiasT, RES, F32>(a, acc1, row0 + 64 + warp * 16 + g8, ct * BN, tig);
    }
  }
  if (GATE && tw == 0) tma_store_wait<0>();
}

// One wgmma of a 32-byte k-step by the accumulator's type: bf16 operands
// into fp32 (m64nBNk16), or s8 operands into s32 (m64nBNk32).
template <int BN>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {
  Gmma<BN>::ss(d, da, db, scale_d);
}
template <int BN>
__device__ __forceinline__ void wgmma_ss(int* d, uint64_t da, uint64_t db, int scale_d) {
  GmmaS8<BN>::ss(d, da, db, scale_d);
}

// A cooperative consumer's products for one tile: k_blocks ring stages from
// the block's g-th on, each an A slab (this warpgroup's 64 rows at a_off
// bytes into the stage) and a B slab of BN rows after the A tile, four
// wgmma a stage (one a 32-byte k-step of the 128-byte rows: m64nBNk16 on
// bf16 into fp32 acc, m64nBNk32 on s8 into s32 acc). The first k-block is
// peeled (its first product overwrites the accumulator, with no branch
// around the batch). Returns with the products done and every stage
// released; g advanced.
template <int BN, typename Acc>
__device__ __forceinline__ void coop_products(Acc (&acc)[BN / 2], uint32_t ring, uint32_t bars,
                                              int stages, uint32_t a_off, int k_blocks, int& g) {
  constexpr int STAGE = stage_bytes<BN>();
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  int s = g % stages;
  mbar_wait(full(s), (g / stages) & 1);
  {
    const uint32_t sa = ring + s * STAGE + a_off, sb = ring + s * STAGE + A_BYTES;
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<BN>(acc, gmma_desc(sa + kk * 32), gmma_desc(sb + kk * 32), kk > 0);
    wgmma_commit();
    fence_regs<BN / 2>(acc);
  }
  int prev = s;
  ++g;
  for (int kb = 1; kb < k_blocks; ++kb, ++g) {
    s = g % stages;
    mbar_wait(full(s), (g / stages) & 1);
    const uint32_t sa = ring + s * STAGE + a_off, sb = ring + s * STAGE + A_BYTES;
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<BN>(acc, gmma_desc(sa + kk * 32), gmma_desc(sb + kk * 32), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous k-block's products are done with its stage
    fence_regs<BN / 2>(acc);
    mbar_arrive(empty(prev));
    prev = s;
  }
  wgmma_wait<0>();
  fence_regs<BN / 2>(acc);
  mbar_arrive(empty(prev));
}

// The out GEMM at BN = 256 (C >= 256 where the tiles fill the card):
// y = bf16(act W2^T + b2) (+ res), tiles of 128 rows by 256 columns, both
// consumer warpgroups on each tile (64 rows each, one m64n256 accumulator),
// so each 32 KB B slab serves 128 rows; its epilogue is a bias add, one
// rounding (and the residual). The body of a __global__ of THREADS threads.
template <int BN, typename BiasT, bool RES, bool F32 = false>
__device__ __forceinline__ void coop_gemm(const CUtensorMap* tm_act, const CUtensorMap* tm_w2,
                                          const GemmArgs& a) {
  constexpr int STAGE = stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + a.stages * STAGE;
  const int tiles = (a.rows + BM - 1) / BM * a.col_tiles;
  init_ring(bars, a.stages, 256);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) produce<BN, false>(tm_act, tm_w2, a, ring, bars);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, tw = threadIdx.x - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31, g8 = lane >> 2, tig = lane & 3;
  float acc[BN / 2];
  int g = 0;  // stages consumed by this block
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = (t / a.col_tiles) * BM, ct = t % a.col_tiles;
    coop_products<BN>(acc, ring, bars, a.stages, c * 64 * ROW_BYTES, a.k_blocks, g);
    store_rows<BN, BiasT, RES, F32>(a, acc, row0 + c * 64 + warp * 16 + g8, ct * BN, tig);
  }
}

// The epilogues of coop_staged_gemm: y = bf16(acc + bias); y = bf16(acc *
// scale) with no bias (as the TPU body scales q in fp32, then rounds); y =
// bf16(bf16(acc + bias) + res), the bf16 residual added after the first
// rounding; y = bf16(acc), no bias (a zero fp32 bias would turn -0 into +0).
enum StagedEpi { EPI_BIAS = 0, EPI_SCALE = 1, EPI_BIAS_RES = 2, EPI_NONE = 3 };

constexpr int STAGED_ROWS = 64;  // a consumer warpgroup's rows of a tile

// coop_staged_gemm's shared bytes after the ring: a staging box of 64 rows
// by bn bf16 columns a consumer warpgroup, then (after the ring's barriers)
// one residual barrier each
__host__ __device__ constexpr int staged_extra(int bn) { return 2 * bn * STAGED_ROWS * 2 + 16; }

// A cooperative GEMM whose output leaves by TMA: tiles of 128 rows by BN
// columns, both consumer warpgroups on each tile (64 rows each, one
// m64nBN accumulator), each writing its 64 x BN bf16 result into its
// staging box and one of its threads storing the box by TMA, so the tile
// leaves as whole rows where stores from registers write 16 bytes of a row
// at a time. At BN a multiple of 64 the box is BN / 64 slabs laid out as
// the 128-byte swizzled TMA box; at BN = 160 it is one dense 64 x 160 box
// (a swizzled slab is 64 columns wide). With EPI_BIAS_RES the residual tile
// arrives by TMA in the same box while the products run and is read back
// from it. The bias is fp32. The output columns come in GROUPS groups of
// col_tiles / GROUPS tiles (GROUPS outputs of one A operand, each with its
// own B map in tm_b[] and output map in tm_out[]); tm_out and tm_res are
// 2-D maps over (ldo, rows) with boxes of 64 rows (and, at BN = 160, of
// 160 dense columns), which TMA clips at a.rows. The body of a __global__
// of THREADS threads.
template <int BN, int EPI, int GROUPS = 1>
__device__ __forceinline__ void coop_staged_gemm(const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                                 const CUtensorMap* tm_out, const CUtensorMap* tm_res,
                                                 const GemmArgs& a) {
  constexpr int STAGE = stage_bytes<BN>();
  constexpr bool SWIZZLED = BN % SLAB == 0;
  constexpr int SLABS = SWIZZLED ? BN / SLAB : 1;
  constexpr int BOX = SWIZZLED ? STAGED_ROWS * ROW_BYTES : STAGED_ROWS * BN * 2;  // one store's box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t staging = ring + a.stages * STAGE;
  const uint32_t bars = staging + 2 * SLABS * BOX;
  const int tiles = (a.rows + BM - 1) / BM * a.col_tiles;
  if (threadIdx.x == 0) {
    mbar_init(bars + 16 * MAX_STAGES, 1);
    mbar_init(bars + 16 * MAX_STAGES + 8, 1);
  }
  init_ring(bars, a.stages, 256);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) produce<BN, false, GROUPS>(tm_a, tm_b, a, ring, bars);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, tw = threadIdx.x - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31, g8 = lane >> 2, tig = lane & 3;
  const uint32_t box = staging + c * SLABS * BOX, res_bar = bars + 16 * MAX_STAGES + 8 * c;
  float acc[BN / 2];
  int g = 0;   // stages consumed by this block
  int it = 0;  // tiles of this block so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++it) {
    const int2 gt = group_tile<GROUPS>(t % a.col_tiles, a.col_tiles);
    const int r0 = (t / a.col_tiles) * BM + c * STAGED_ROWS, n0 = gt.y * BN;
    if (tw == 0) {
      tma_store_wait_read<0>();  // the previous tile's store has read the box
      if constexpr (EPI == EPI_BIAS_RES) {
        mbar_expect_tx(res_bar, SLABS * BOX);
#pragma unroll
        for (int q = 0; q < SLABS; ++q) tma_load_2d(box + q * BOX, tm_res, res_bar, n0 + q * SLAB, r0);
      }
    }
    coop_products<BN>(acc, ring, bars, a.stages, c * STAGED_ROWS * ROW_BYTES, a.k_blocks, g);
    if constexpr (EPI == EPI_BIAS_RES)
      mbar_wait(res_bar, it & 1);
    else
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c));  // the box is free

    // acc[4j + e] is row warp * 16 + g8 + 8 * (e / 2), column 8j + 2 * tig +
    // e % 2 of the warpgroup's rows: swizzled, 16-byte chunk j % 8 of its
    // row in slab j / 8 of the box; dense, bytes 16j + 4 * tig of its row
    const float* bb = static_cast<const float*>(a.bias) + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float2 bv = make_float2(0.f, 0.f);
      if constexpr (EPI == EPI_BIAS || EPI == EPI_BIAS_RES) bv = bias2(bb + 8 * j + 2 * tig);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g8 + 8 * h;
        const uint32_t addr = SWIZZLED ? box + (j / 8) * BOX + swizzled(row, j % 8) + tig * 4
                                       : box + row * (BN * 2) + j * 16 + tig * 4;
        const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
        __nv_bfloat162 v;
        if constexpr (EPI == EPI_SCALE)
          v = __floats2bfloat162_rn(x0 * a.scale, x1 * a.scale);
        else if constexpr (EPI == EPI_NONE)
          v = __floats2bfloat162_rn(x0, x1);
        else
          v = __floats2bfloat162_rn(x0 + bv.x, x1 + bv.y);
        if constexpr (EPI == EPI_BIAS_RES) {
          uint32_t rv;
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(rv) : "r"(addr));
          v = __hadd2(v, *reinterpret_cast<const __nv_bfloat162*>(&rv));
        }
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(*reinterpret_cast<uint32_t*>(&v)));
      }
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c));
    if (tw == 0) {  // rows past a.rows are not written
#pragma unroll
      for (int q = 0; q < SLABS; ++q) tma_store_2d(tm_out + gt.x, box + q * BOX, n0 + q * SLAB, r0);
      tma_store_commit();
    }
  }
  if (tw == 0) tma_store_wait<0>();
}

// the shared bytes of a ring of `stages` stages of `stage` bytes and `extra`
// bytes after it, with the 1 KB alignment slack and the barriers
inline int ring_smem(int stages, int stage, int extra) {
  return 1024 + stages * stage + extra + 16 * MAX_STAGES;
}

inline cudaError_t set_smem(const void* kernel, int smem) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The host's checks of a staged GEMM's plan (coop_staged_gemm over `rows`
// rows and `groups` outputs of out_cols columns): a tile width with an
// instance (128, 160 or 256) dividing out_cols, a ring within the barrier
// slots and the shared memory beside the staging boxes, a grid, and a tile
// count within int.
inline bool staged_plan_ok(int rows, int out_cols, int groups, int bn, int stages, int grid) {
  const long long tiles =
      (long long)(rows + BM - 1) / BM * groups * (out_cols / (bn > 0 ? bn : 1));
  return rows >= 1 && (bn == 128 || bn == 160 || bn == 256) && out_cols >= bn &&
         out_cols % bn == 0 && stages >= 2 && stages <= MAX_STAGES && grid >= 1 &&
         tiles <= 0x7fffffffLL &&
         ring_smem(stages, (BM + bn) * ROW_BYTES, staged_extra(bn)) <= SMEM_LIMIT;
}

// coop_staged_gemm's map of an (rows, cols) output or residual at tile
// width bn: boxes of 64 rows by one swizzled slab, or at bn = 160 one dense
// 64 x 160 box; false if the encoder refused it.
inline bool make_staging_map(CUtensorMap* m, const void* p, int cols, int rows, int bn) {
  return bn % SLAB == 0 ? make_map_2d(m, p, cols, rows, STAGED_ROWS)
                        : make_map_2d_dense(m, p, cols, rows, bn, STAGED_ROWS);
}

// Launch a persistent GEMM kernel(maps..., a) over a's tiles: at most `grid`
// blocks of THREADS threads and `smem` dynamic shared bytes.
template <typename Kernel, typename... Maps>
cudaError_t launch_gemm(Kernel kernel, int smem, const GemmArgs& a, int grid, cudaStream_t st,
                        const Maps&... maps) {
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.rows + BM - 1) / BM * a.col_tiles;
  kernel<<<grid < tiles ? grid : tiles, THREADS, smem, st>>>(maps..., a);
  return cudaGetLastError();
}

}  // namespace wgemm
