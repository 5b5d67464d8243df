// GEGLU feed-forward of the transformer blocks:
//   act = bf16((x W0h^T + b0h) * gelu_erf(x W0g^T + b0g))
//   y   = bf16(act W2^T + b2)
// with x (N, C), W0 = [W0h; W0g] (2I, C), W2 (C, I), I = 4C (nn.Linear
// weight layouts, bf16), fp32 accumulation on both products; act is rounded
// to bf16 before the second product, as the TPU body rounds it.
//
// Replaces: lavie_tpu/kernels/geglu.py, geglu (_geglu_2d, body
// _geglu_kernel).
//
// What bounds it on the H100: tensor-core operations. One base level is
// 6*N*C*I = 201 GFLOP (N = 81920, C = 320), 0.20 ms at 989 TFLOP/s dense
// bf16, against 2*N*C*2 bytes of activations (105 MB, 31 us at 3.35 TB/s).
//
// What the design does about it: two persistent, warp-specialised wgmma
// GEMMs, launched back to back on the stream by one call.
//   gate GEMM: act (N, I) from x (N, C): a tile is 128 rows by 64 columns
//     of the hidden and the same 64 columns of the gate; B is two TMA boxes
//     of W0 (hidden rows i0.., gate rows I + i0..) laid one after the other,
//     so one m64n128k16 wgmma gives a warpgroup the hidden and the gate of
//     the same columns in the same thread; the epilogue adds b0, applies the
//     gelu gate in registers (the TPU body's erf polynomial: one reciprocal
//     and one exponential) and stores bf16 act by TMA from a staging box.
//     Its K (= C, 5 slabs at C = 320) is short and its epilogue long, so the
//     two consumer warpgroups take turns (ping-pong): each owns whole
//     tiles, and one's epilogue runs under the other's products.
//   out GEMM: y (N, C) from act over K = I, output tiles of 128 rows by a
//     legal wgmma width dividing C (128, 160 or 256); the epilogue adds b2
//     and rounds once. At 128 and 160 the consumer warpgroups take turns as
//     in the gate GEMM; at 256 (one m64n256 accumulator a warpgroup) both
//     work on each tile, 64 rows each.
// Both: warpgroup 0 is the producer, one thread keeping a ring of 4-6 stages
// of TMA loads in flight (the A tile's 64-column slab and the B slab, both
// K-major in 128-byte swizzled boxes) across tiles, and wgmma reads both
// operands from shared memory. Tiles walk the columns fastest, so the
// blocks running at one time share A row tiles and all of the weights (2.5
// to 39 MB) through the 50 MB L2.
// The act round trip (4*N*I bytes) is the design's cost: a row tile's 640 KB
// fp32 output at C = 1280 cannot stay in one SM's registers across the
// second product.

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int BM = 128;          // rows of a tile
constexpr int THREADS = 384;     // warpgroup 0 produces, 1 and 2 consume
constexpr int GATE_COLS = 64;    // act columns of a gate tile: 64 hidden, 64 gate rows of W0
constexpr int A_BYTES = BM * ROW_BYTES;  // one 64-column slab of an A tile
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;

struct GemmArgs {
  const bf16* bias;  // b0 (2I) or b2 (C)
  bf16* out;         // act (rows, I) or y (rows, C)
  int rows;          // rows of A and of the output
  int ldo;           // the output's row stride: I or C
  int k_blocks;      // K / 64
  int col_tiles;     // output column tiles a row tile
  int stages;
  int inner;         // I: the gate rows' offset in W0 and b0
};

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

// The producer thread: for each of the block's tiles and each 64-column
// slab of K, one ring stage: the A slab (BM rows) and the B slab. GATE: B is
// W0's 64 hidden rows of the tile's columns, then the 64 gate rows I + those
// columns; else BN rows of W2.
template <int BN, bool GATE>
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
        tma_load_2d(sb, tm_b, full, kb * SLAB, tc.y * BN);
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
// else the out GEMM: y = bf16(act W2^T + b2) at BN = 128 or 160 (C <= 640
//   and the narrow levels), where its epilogue (a bias add, one rounding,
//   stores from registers) would leave the tensor cores idle.
template <int BN, bool GATE>
__global__ void __launch_bounds__(THREADS, 1) geglu_pingpong_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const __grid_constant__ CUtensorMap tm_act, const GemmArgs a) {
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
    if (threadIdx.x == 0) produce<BN, GATE>(&tm_a, &tm_b, a, ring, bars);
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
      const bf16* bh = a.bias + ct * GATE_COLS;
      const bf16* bg = bh + a.inner;
      auto epilogue = [&](const float (&acc)[BN / 2], int r) {
#pragma unroll
        for (int j = 0; j < GATE_COLS / 8; ++j) {
          const int col = 8 * j + 2 * tig;
          const float2 hb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bh + col));
          const float2 gb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bg + col));
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
        tma_store_2d(&tm_act, box, ct * GATE_COLS, row0);
        tma_store_commit();
      }
    } else {
      const bf16* bb = a.bias + ct * BN;
      auto epilogue = [&](const float (&acc)[BN / 2], int r0) {
        bf16* o0 = a.out + (size_t)r0 * a.ldo + ct * BN;
        bf16* o1 = o0 + (size_t)8 * a.ldo;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = 8 * j + 2 * tig;
          const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bb + col));
          if (r0 < a.rows)
            *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
                __floats2bfloat162_rn(acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
          if (r0 + 8 < a.rows)
            *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
                __floats2bfloat162_rn(acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
        }
      };
      epilogue(acc0, row0 + warp * 16 + g8);
      epilogue(acc1, row0 + 64 + warp * 16 + g8);
    }
  }
  if (GATE && tw == 0) tma_store_wait<0>();
}

// The out GEMM at BN = 256 (C >= 256 where the tiles fill the card):
// y = bf16(act W2^T + b2), tiles of 128 rows by 256 columns, both consumer
// warpgroups on each tile (64 rows each, one m64n256 accumulator), so each
// 32 KB B slab serves 128 rows; its epilogue is a bias add and one rounding.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) geglu_coop_kernel(
    const __grid_constant__ CUtensorMap tm_act, const __grid_constant__ CUtensorMap tm_w2,
    const GemmArgs a) {
  constexpr int STAGE = stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = ring + a.stages * STAGE;
  const int tiles = (a.rows + BM - 1) / BM * a.col_tiles;
  init_ring(bars, a.stages, 256);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) produce<BN, false>(&tm_act, &tm_w2, a, ring, bars);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, tw = threadIdx.x - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31, g8 = lane >> 2, tig = lane & 3;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  float acc[BN / 2];
  int g = 0;  // stages consumed by this block
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = (t / a.col_tiles) * BM, ct = t % a.col_tiles;
    // the first k-block, peeled: its first product overwrites the accumulator
    int s = g % a.stages;
    mbar_wait(full(s), (g / a.stages) & 1);
    {
      const uint32_t sa = ring + s * STAGE + c * 64 * ROW_BYTES, sb = ring + s * STAGE + A_BYTES;
      fence_regs<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Gmma<BN>::ss(acc, gmma_desc(sa + kk * 32), gmma_desc(sb + kk * 32), kk > 0);
      wgmma_commit();
      fence_regs<BN / 2>(acc);
    }
    int prev = s;
    ++g;
    for (int kb = 1; kb < a.k_blocks; ++kb, ++g) {
      s = g % a.stages;
      mbar_wait(full(s), (g / a.stages) & 1);
      const uint32_t sa = ring + s * STAGE + c * 64 * ROW_BYTES, sb = ring + s * STAGE + A_BYTES;
      fence_regs<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Gmma<BN>::ss(acc, gmma_desc(sa + kk * 32), gmma_desc(sb + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-block's products are done with its stage
      fence_regs<BN / 2>(acc);
      mbar_arrive(empty(prev));
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs<BN / 2>(acc);
    mbar_arrive(empty(prev));

    // epilogue: acc[4j + e] is row g8 + 8 * (e / 2) of this warp's 16,
    // column 8j + 2 * tig + e % 2 of the tile
    const int r0 = row0 + c * 64 + warp * 16 + g8, r1 = r0 + 8;
    const bf16* bb = a.bias + ct * BN;
    bf16* o0 = a.out + (size_t)r0 * a.ldo + ct * BN;
    bf16* o1 = o0 + (size_t)8 * a.ldo;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bb + col));
      if (r0 < a.rows)
        *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
            __floats2bfloat162_rn(acc[4 * j] + bv.x, acc[4 * j + 1] + bv.y);
      if (r1 < a.rows)
        *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] + bv.x, acc[4 * j + 3] + bv.y);
    }
  }
}

// the shared bytes of a ring of `stages` stages of `stage` bytes and `extra`
// bytes after it, with the 1 KB alignment slack and the barriers
int ring_smem(int stages, int stage, int extra) {
  return 1024 + stages * stage + extra + 16 * MAX_STAGES;
}

cudaError_t set_smem(const void* kernel, int smem) {
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int BN, bool GATE>
cudaError_t launch_pingpong(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& m_act,
                            const GemmArgs& a, int grid, cudaStream_t st) {
  const int smem = ring_smem(a.stages, stage_bytes<BN>(), GATE ? 2 * A_BYTES : 0);
  cudaError_t err = set_smem((const void*)geglu_pingpong_kernel<BN, GATE>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.rows + BM - 1) / BM * a.col_tiles;
  geglu_pingpong_kernel<BN, GATE><<<grid < tiles ? grid : tiles, THREADS, smem, st>>>(ma, mb, m_act,
                                                                                       a);
  return cudaGetLastError();
}

cudaError_t launch_out(const CUtensorMap& ma, const CUtensorMap& mb, const GemmArgs& a, int bn,
                       int grid, cudaStream_t st) {
  switch (bn) {
    case 128: return launch_pingpong<128, false>(ma, mb, ma, a, grid, st);
    case 160: return launch_pingpong<160, false>(ma, mb, ma, a, grid, st);
    case 256: {
      const int smem = ring_smem(a.stages, stage_bytes<256>(), 0);
      cudaError_t err = set_smem((const void*)geglu_coop_kernel<256>, smem);
      if (err != cudaSuccess) return err;
      const int tiles = (a.rows + BM - 1) / BM * a.col_tiles;
      geglu_coop_kernel<256><<<grid < tiles ? grid : tiles, THREADS, smem, st>>>(ma, mb, a);
      return cudaGetLastError();
    }
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (N, C), w0 (2I, C), b0 (2I), w2 (C, I), b2 (C), y (N, C): bf16,
// contiguous, 32-byte aligned, I = 4C, C a multiple of 64. act: bf16 scratch
// of N x I. The launch plan (kernels/geglu.py::launch_plan):
// gate_stages and out_stages ring stages; the out GEMM's tile width out_bn
// (128, 160 or 256, dividing C); at most `grid` persistent blocks a GEMM.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan
// the kernels cannot take.
extern "C" int geglu_bf16(const void* x, const void* w0, const void* b0, const void* w2,
                          const void* b2, void* y, void* act, int N, int C, int I,
                          int gate_stages, int out_bn, int out_stages, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (I != 4 * C || N < 1 || C < 64 || C % 64 || grid < 1 || out_bn < 8 || C % out_bn ||
      gate_stages < 2 || gate_stages > MAX_STAGES || out_stages < 2 || out_stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  bf16* actb = static_cast<bf16*>(act);
  CUtensorMap m_x, m_w0, m_act, m_w2;
  if (!make_map_2d(&m_x, x, C, N, BM) || !make_map_2d(&m_w0, w0, C, 2 * I, GATE_COLS) ||
      !make_map_2d(&m_act, actb, I, N, BM) || !make_map_2d(&m_w2, w2, I, C, out_bn))
    return (int)cudaErrorNotSupported;
  const GemmArgs gate{static_cast<const bf16*>(b0), actb, N, I, C / SLAB, I / GATE_COLS,
                      gate_stages, I};
  cudaError_t err = launch_pingpong<2 * GATE_COLS, true>(m_x, m_w0, m_act, gate, grid, st);
  if (err != cudaSuccess) return (int)err;
  const GemmArgs out{static_cast<const bf16*>(b2), static_cast<bf16*>(y), N, C, I / SLAB,
                     C / out_bn, out_stages, I};
  err = launch_out(m_act, m_w2, out, out_bn, grid, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaSuccess;
}
