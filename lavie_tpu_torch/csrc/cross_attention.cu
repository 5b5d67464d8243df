// Short-kv cross attention: softmax(q k^T * scale) v of long query
// sequences against a few text keys, for the text cross-attention (attn2)
// of every non-only-cross transformer block.
//
// Replaces: lavie_tpu/kernels/cross_attention.py, cross_attention
// (_cross_bhsd, body _cross_kernel).
//
// What it computes, per batch b and head h, on q[b, :, h, :] (S x D) and
// k[b, :, h, :], v[b, :, h, :] (L x D, L <= 256):
//   scores = fp32 dot(q_i, k_j), then * scale in fp32 (the scale goes on
//            the scores, not on q; here folded with log2(e) into one
//            multiply, for ex2);
//   p = exact max-subtracted softmax over j in one pass (the whole kv is
//       resident, so no online rescale), one reciprocal per row, rounded to
//       bf16;
//   out = p v accumulated in fp32, rounded once to bf16.
// Layout: q, out (B, S, H, D) and k, v (B, L, H, D), as the projections
// produce them; D a multiple of 8 up to 160; any S (the last tile is
// ragged).
//
// What bounds it on the H100: device-memory bytes. At the base L0 level
// (q of 2 x 40,960 x 8 x 40) a call reads q and writes out once, 105 MB,
// 0.031 ms at 3.35 TB/s, while its 4*B*H*S*L*D = 8 GFLOP take 0.008 ms at
// 989 TFLOP/s: about 77 flops a byte, far below the card's ~295.
//
// What the design does about it: keep bytes in flight, move whole sectors,
// and spend few instructions a query. Persistent blocks, one an SM
// (kernels/cross_attention.py::launch_plan), walk work items of (b, h, 64
// queries), heads fastest, block i taking items i, i + grid, ...: with a
// grid that is a multiple of H every block keeps one head, and the blocks
// running at one time read and write every head of the same query rows, so
// the rows' sectors (a head is 80 bytes of a 640-byte row at d = 40) are
// filled in L2 by the neighbours together, not fetched and written back
// once per head. One producer thread loads a head's K and V by TMA once per
// (b, h) the block serves, and keeps a ring of query tiles in flight, each
// one 128-byte swizzled TMA box per 64 columns of a 4-D map over (D, H, S,
// B) (the flash kernel's map; TMA zero-fills the columns past D and the rows
// past S or L).
//   L <= 80 (the 77 text tokens; cross_kernel): two consumer warpgroups
//     take the block's items in turn, on wgmma like the flash body: S = Q K^T
//     (m64n80k16, both operands K-major in the swizzled boxes), the softmax
//     in the accumulator registers with quad shuffles and ex2, then O = P V
//     with P from registers and V an MN-major B operand, so V needs no
//     transpose and no ldmatrix runs at all. The output tile goes back into
//     its query tile's stage, laid out as the box, and leaves by one TMA
//     store of whole rows, as coalesced as the loads; the stage returns to
//     the producer once a later store shows it read.
//   80 < L <= 256 (cross_long_kernel): a row's 256 scores do not fit beside
//     a wgmma accumulator, so each warp owns 16 queries on mma.sync m16n8k16,
//     Q and K fragments by ldmatrix, V by ldmatrix.trans (the swizzle keeps
//     the eight rows of each ldmatrix in distinct banks), P straight from
//     the score registers, and stores from registers.
// The next tiles' loads are in flight meanwhile.

#include "hopper.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace hopper;
using tiles::bf16;
using tiles::mma16816;
using tiles::pack_bf16;

constexpr int MAX_STAGES = 8;
constexpr int LONG_KEYS = 256;  // keys a thread's scores cover in cross_long_kernel

__device__ __forceinline__ void ldsm4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

struct CrossArgs {
  bf16* out;
  int S, H, D, L;
  int kv_rows;    // the K and V rows in shared memory: KEYS for L <= KEYS
                  // (every row the wgmma products read), else L rounded up to 16
  int tile;       // queries per work item
  int stages;     // query tiles in the ring
  int items;
  float scale_log2;
};

// Shared memory: K and V (SLABS slabs of kv_rows 128-byte rows each), the
// ring of query tiles, then the barriers: full[MAX_STAGES],
// empty[MAX_STAGES], kv_full, kv_empty.
struct Smem {
  uint32_t k, v, q, bars, kv_slab, q_slab;
  __device__ Smem(const CrossArgs& a, int slabs, const void* raw) {
    k = (smem_u32(raw) + 1023) & ~1023u;  // the swizzle atom is 1024 bytes
    kv_slab = a.kv_rows * ROW_BYTES;
    q_slab = a.tile * ROW_BYTES;
    v = k + slabs * kv_slab;
    q = v + slabs * kv_slab;
    bars = q + a.stages * slabs * q_slab;
  }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (MAX_STAGES + s); }
  __device__ uint32_t kv_full() const { return bars + 16 * MAX_STAGES; }
  __device__ uint32_t kv_empty() const { return bars + 16 * MAX_STAGES + 8; }
  __device__ uint32_t stage(int s, int slabs) const { return q + s * slabs * q_slab; }
};

// Item w of a call: head w % H, query tile (w / H) % tiles, batch
// w / (H * tiles).
struct Item {
  int h, qt, b, bh;
  __device__ Item(const CrossArgs& a, int w) {
    const int qtiles = (a.S + a.tile - 1) / a.tile;
    h = w % a.H;
    qt = (w / a.H) % qtiles;
    b = w / (a.H * qtiles);
    bh = b * a.H + h;
  }
};

__device__ __forceinline__ void init_barriers(const Smem& m, int stages, int stage_readers,
                                              int kv_readers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(m.full(s), 1);
      mbar_init(m.empty(s), stage_readers);
    }
    mbar_init(m.kv_full(), 1);
    mbar_init(m.kv_empty(), kv_readers);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer thread: K and V when the block's (b, h) changes (once its
// readers released the previous pair), and each item's query tile into the
// ring.
template <int SLABS>
__device__ __forceinline__ void produce(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, const CrossArgs& a,
                                        const Smem& m) {
  int bh_prev = -1;
  int kvn = 0;
  for (int w = blockIdx.x, n = 0; w < a.items; w += gridDim.x, ++n) {
    const Item it(a, w);
    if (it.bh != bh_prev) {
      if (kvn > 0) mbar_wait(m.kv_empty(), (kvn - 1) & 1);
      mbar_expect_tx(m.kv_full(), 2 * SLABS * m.kv_slab);
      for (int sl = 0; sl < SLABS; ++sl) {
        tma_load_4d(m.k + sl * m.kv_slab, tm_k, m.kv_full(), sl * SLAB, it.h, 0, it.b);
        tma_load_4d(m.v + sl * m.kv_slab, tm_v, m.kv_full(), sl * SLAB, it.h, 0, it.b);
      }
      ++kvn;
      bh_prev = it.bh;
    }
    const int s = n % a.stages;
    if (n >= a.stages) mbar_wait(m.empty(s), ((n / a.stages) - 1) & 1);
    const uint32_t qd = m.stage(s, SLABS);
    mbar_expect_tx(m.full(s), SLABS * m.q_slab);
    for (int sl = 0; sl < SLABS; ++sl)
      tma_load_4d(qd + sl * m.q_slab, tm_q, m.full(s), sl * SLAB, it.h, it.qt * a.tile, it.b);
  }
}

// ---- L <= 80: wgmma -------------------------------------------------------

constexpr int KEYS = 80;         // the score tile's width: L <= 80 keys, the rest masked
constexpr int WG_ROWS = 64;      // queries an item: one consumer warpgroup's

constexpr int THREADS = 384;     // warpgroup 0 produces, 1 and 2 consume
constexpr int CW = 2;            // consumer warpgroups

// DP: D rounded up to 16 (the instance for every D of it)
template <int DP>
struct Cfg {
  static constexpr int SLABS = (DP + SLAB - 1) / SLAB;
  // P V's width in slabs 0, 1, 2: 64, or the last slab's columns
  static constexpr int LAST = DP - SLAB * (SLABS - 1);
  static constexpr int NW0 = SLABS > 1 ? SLAB : LAST;
  static constexpr int NW1 = SLABS > 2 ? SLAB : LAST;
  static constexpr int NW2 = LAST;
  static_assert(NW0 + NW1 + NW2 >= 0, "");  // each is used by some instance
};

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) cross_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
    const CrossArgs a) {
  constexpr int SLABS = Cfg<DP>::SLABS;
  extern __shared__ unsigned char smem_raw[];
  const Smem m(a, SLABS, smem_raw);
  // a stage is released by the thread that stores its item's output from
  // it; K and V by every consumer thread
  init_barriers(m, a.stages, 1, 128 * CW);

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) produce<SLABS>(&tm_q, &tm_k, &tm_v, a, m);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg - 1, tw = threadIdx.x - 128 * wg;
  const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, tig = lane & 3;
  float sc[KEYS / 2];        // this thread's scores: rows g, g + 8 of its warp's 16
  uint32_t p[KEYS / 16][4];  // the probabilities in bf16, as wgmma's A fragments
  float o[DP / 2];
  int bh_prev = -1;
  int kvn = 0;
  int pending = -1;  // the stage whose output store this warpgroup issued last
  // every consumer warpgroup walks every item, so each sees every (b, h)
  // change; each computes one item in CW
  for (int w = blockIdx.x, n = 0; w < a.items; w += gridDim.x, ++n) {
    const Item it(a, w);
    if (it.bh != bh_prev) {
      if (kvn > 0) mbar_arrive(m.kv_empty());  // done with the previous head's K and V
      mbar_wait(m.kv_full(), kvn & 1);
      ++kvn;
      bh_prev = it.bh;
    }
    if (n % CW != c) continue;
    const int s = n % a.stages;
    mbar_wait(m.full(s), (n / a.stages) & 1);
    const uint32_t qd = m.stage(s, SLABS);

    // S = Q K^T over ceil(D / 16) k-steps (the columns past D are zeros)
    fence_regs<KEYS / 2>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Gmma<KEYS>::ss(sc, gmma_desc(qd + (kk / 4) * m.q_slab + (kk % 4) * 32),
                     gmma_desc(m.k + (kk / 4) * m.kv_slab + (kk % 4) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<KEYS / 2>(sc);

    // exact softmax over the L keys, in log2 units; sc[i] is column
    // 8 * (i / 4) + 2 * tig + i % 2 of row g + 8 * ((i / 2) % 2)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      const int col = (i >> 2) * 8 + tig * 2 + (i & 1);
      sc[i] = col < a.L ? sc[i] * a.scale_log2 : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    }
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      sc[i] = ex2(sc[i] - mx[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += sc[i];
    }
    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
      inv[hr] = 1.f / sum[hr];
    }
    // P in bf16: the accumulator layout of two n8 chunks is the A fragment
    // of one k16 step
#pragma unroll
    for (int j = 0; j < KEYS / 16; ++j) {
      p[j][0] = pack_bf16(sc[8 * j + 0] * inv[0], sc[8 * j + 1] * inv[0]);
      p[j][1] = pack_bf16(sc[8 * j + 2] * inv[1], sc[8 * j + 3] * inv[1]);
      p[j][2] = pack_bf16(sc[8 * j + 4] * inv[0], sc[8 * j + 5] * inv[0]);
      p[j][3] = pack_bf16(sc[8 * j + 6] * inv[1], sc[8 * j + 7] * inv[1]);
    }

    // O = P V, V MN-major in its slabs
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    fence_regs_u<KEYS / 4>(&p[0][0]);
    fence_regs<DP / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KEYS / 16; ++j) {
      GmmaRs<Cfg<DP>::NW0>::rs(o, p[j], gmma_desc(m.v + j * 16 * ROW_BYTES));
      if constexpr (SLABS > 1)
        GmmaRs<Cfg<DP>::NW1>::rs(o + 32, p[j], gmma_desc(m.v + m.kv_slab + j * 16 * ROW_BYTES));
      if constexpr (SLABS > 2)
        GmmaRs<Cfg<DP>::NW2>::rs(o + 64, p[j], gmma_desc(m.v + 2 * m.kv_slab + j * 16 * ROW_BYTES));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(o);
    fence_regs_u<KEYS / 4>(&p[0][0]);

    // store: the output tile goes into the query tile's stage, laid out as
    // the TMA box it was loaded from, and one thread stores it by TMA (the
    // rows past S and the columns past D are not written); the stage is
    // released once a later store shows this one read
    const int r0 = 16 * warp + g;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      // o[4i..4i+3]: columns 8(i % 8) + 2tig (+1) of slab i / 8, rows r0 and r0 + 8
      const uint32_t at = qd + (i / 8) * m.q_slab + tig * 4;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + swizzled(r0, i % 8)),
                   "r"(pack_bf16(o[4 * i], o[4 * i + 1])));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + swizzled(r0 + 8, i % 8)),
                   "r"(pack_bf16(o[4 * i + 2], o[4 * i + 3])));
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c));
    if (tw == 0) {
      for (int sl = 0; sl < SLABS; ++sl)
        tma_store_4d(&tm_o, qd + sl * m.q_slab, sl * SLAB, it.h, it.qt * a.tile, it.b);
      tma_store_commit();
      if (pending >= 0) {
        tma_store_wait_read<1>();
        mbar_arrive(m.empty(pending));
      }
      pending = s;
    }
  }
  if (tw == 0) tma_store_wait<0>();
}

// ---- 80 < L <= 256: mma.sync ----------------------------------------------

constexpr int LONG_THREADS = 160;  // 64-query tiles: four warps, and the producer warp

template <int DP>
__global__ void __launch_bounds__(LONG_THREADS, 1) cross_long_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const CrossArgs a) {
  constexpr int SLABS = (DP + SLAB - 1) / SLAB, LP = LONG_KEYS;
  extern __shared__ unsigned char smem_raw[];
  const Smem m(a, SLABS, smem_raw);
  const int consumers = a.tile / 16;  // warps; warp `consumers` produces
  // each consumer warp arrives once on a stage and on K and V
  init_barriers(m, a.stages, consumers, consumers);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == consumers) {
    if (lane == 0) produce<SLABS>(&tm_q, &tm_k, &tm_v, a, m);
    return;
  }
  const int g = lane >> 2, tig = lane & 3;
  int bh_prev = -1;
  int kvn = 0;
  for (int w = blockIdx.x, n = 0; w < a.items; w += gridDim.x, ++n) {
    const Item it(a, w);
    if (it.bh != bh_prev) {
      if (kvn > 0) {  // done with the previous head's K and V
        __syncwarp();
        if (lane == 0) mbar_arrive(m.kv_empty());
      }
      mbar_wait(m.kv_full(), kvn & 1);
      ++kvn;
      bh_prev = it.bh;
    }
    const int s = n % a.stages;
    mbar_wait(m.full(s), (n / a.stages) & 1);
    const uint32_t qd = m.stage(s, SLABS);
    const int row0 = it.qt * a.tile + warp * 16;  // this warp's first query
    const bool live = row0 < a.S;

    float sc[LP / 8][4];
#pragma unroll
    for (int nt = 0; nt < LP / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    if (live) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t qa[4];
        const int qrow = warp * 16 + (lane & 15), qch = 2 * kk + (lane >> 4);
        ldsm4(qa, qd + (qch >> 3) * m.q_slab + swizzled(qrow, qch & 7));
        const int kch = 2 * kk + ((lane >> 3) & 1);
#pragma unroll
        for (int np = 0; np < LP / 16; ++np) {
          if (np * 16 < a.kv_rows) {
            uint32_t kb[4];
            const int krow = np * 16 + (lane & 7) + ((lane >> 4) << 3);
            ldsm4(kb, m.k + (kch >> 3) * m.kv_slab + swizzled(krow, kch & 7));
            mma16816(sc[2 * np], qa, kb[0], kb[1]);
            mma16816(sc[2 * np + 1], qa, kb[2], kb[3]);
          }
        }
      }
    }
    __syncwarp();  // this warp's reads of the query tile are done
    if (lane == 0) mbar_arrive(m.empty(s));
    if (!live) continue;

    // exact softmax over the L keys, in log2 units
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < LP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = nt * 8 + tig * 2 + (e & 1) < a.L ? sc[nt][e] * a.scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    }
#pragma unroll
    for (int nt = 0; nt < LP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = ex2(sc[nt][e] - mx[e >> 1]);
        sum[e >> 1] += sc[nt][e];
      }
    float inv[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
      inv[hr] = 1.f / sum[hr];
    }

    // out = P V, P from the score registers, V by ldmatrix.trans
    float o[DP / 8][4];
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < LP / 16; ++j) {
      if (j * 16 < a.kv_rows) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * j][0] * inv[0], sc[2 * j][1] * inv[0]),
                                pack_bf16(sc[2 * j][2] * inv[1], sc[2 * j][3] * inv[1]),
                                pack_bf16(sc[2 * j + 1][0] * inv[0], sc[2 * j + 1][1] * inv[0]),
                                pack_bf16(sc[2 * j + 1][2] * inv[1], sc[2 * j + 1][3] * inv[1])};
        const int vrow = j * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int np = 0; np < DP / 16; ++np) {
          uint32_t vb[4];
          const int vch = 2 * np + (lane >> 4);
          ldsm4_t(vb, m.v + (vch >> 3) * m.kv_slab + swizzled(vrow, vch & 7));
          mma16816(o[2 * np], pa, vb[0], vb[1]);
          mma16816(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
    const size_t row = (size_t)a.H * a.D;  // elements between consecutive tokens
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + g + hr * 8;
      if (r >= a.S) continue;
      bf16* orow = a.out + ((size_t)it.b * a.S + r) * row + (size_t)it.h * a.D;
#pragma unroll
      for (int nt = 0; nt < DP / 8; ++nt)
        if (nt * 8 < a.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + tig * 2) =
              __floats2bfloat162_rn(o[nt][2 * hr], o[nt][2 * hr + 1]);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const CrossArgs& a, int B,
                   int grid, int smem, cudaStream_t st) {
  constexpr int SLABS = Cfg<DP>::SLABS;
  const bool wide = a.L <= KEYS;
  const int need = 1024 + 2 * SLABS * a.kv_rows * ROW_BYTES + a.stages * SLABS * a.tile * ROW_BYTES +
                   16 * (MAX_STAGES + 1);
  // the wide kernel holds up to two stages a consumer warpgroup
  if (smem < need || (wide && a.stages < 2 * CW)) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, a.D, a.H, a.S, B, a.tile) || !make_map(&mk, k, a.D, a.H, a.L, B, a.kv_rows) ||
      !make_map(&mv, v, a.D, a.H, a.L, B, a.kv_rows) || !make_map(&mo, a.out, a.D, a.H, a.S, B, a.tile))
    return cudaErrorNotSupported;
  cudaError_t err;
  if (wide) {
    err = cudaFuncSetAttribute(cross_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cross_kernel<DP><<<grid, THREADS, smem, st>>>(mq, mk, mv, mo, a);
  } else {
    err = cudaFuncSetAttribute(cross_long_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    cross_long_kernel<DP><<<grid, LONG_THREADS, smem, st>>>(mq, mk, mv, a);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const CrossArgs& a, int B,
                     int grid, int smem, cudaStream_t st) {
  switch ((a.D + 15) / 16) {
#define CROSS_CASE(DP) \
  case DP / 16:        \
    return launch<DP>(q, k, v, a, B, grid, smem, st);
    CROSS_CASE(16) CROSS_CASE(32) CROSS_CASE(48) CROSS_CASE(64) CROSS_CASE(80)
    CROSS_CASE(96) CROSS_CASE(112) CROSS_CASE(128) CROSS_CASE(144) CROSS_CASE(160)
#undef CROSS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out (B, S, H, D) bf16; k, v (B, L, H, D) bf16; all contiguous and
// 16-byte aligned. D a multiple of 8 up to 160, 1 <= L <= 256, S >= 1.
// The launch plan (kernels/cross_attention.py::launch_plan): `tile` queries
// a work item (64), a ring of `stages` query tiles, `grid` persistent
// blocks, `smem` dynamic shared bytes. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan the kernel cannot take.
extern "C" int cross_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                    int S, int H, int D, int L, float scale, int tile, int stages,
                                    int grid, int smem, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535 || D < 8 || D > 160 || D % 8 || L < 1 ||
      L > LONG_KEYS || tile != WG_ROWS || stages < 1 || stages > MAX_STAGES || grid < 1 ||
      smem > 232448)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * H * ((S + tile - 1) / tile);
  if (grid > items || items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // L <= KEYS: K and V are loaded KEYS rows deep, TMA zero-filling the
  // rows past L, so that P V (over all KEYS rows of V) multiplies p = 0 by
  // zeros and never by what lies past the V slab
  const int kv_rows = L <= KEYS ? KEYS : (L + 15) / 16 * 16;
  const CrossArgs a{static_cast<bf16*>(out), S, H, D, L, kv_rows, tile, stages, (int)items,
                    scale * 1.4426950408889634f};
  return (int)dispatch(q, k, v, a, B, grid, smem, static_cast<cudaStream_t>(stream));
}
