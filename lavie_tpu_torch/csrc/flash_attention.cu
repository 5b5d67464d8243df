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
// sparse: K_r = concat(anchor[b], prev) over 2S keys for row r = b F + i
//   (frame i of video b): prev = k[r - 1] for i > 0 and halo[b] for i = 0.
//   anchor and halo are operands of their own, B = rows / F rows apart by a
//   stride: a frame-sharded video's frame 0 lives on the first rank and the
//   frame before a shard's first on the rank before. The unsharded call
//   passes frame 0 of each video of k as both (stride F rows), so frame 0
//   attends to itself twice, not deduplicated, exactly as the JAX package
//   computes it;
// kv:     K_r = k[r] over Sk keys.
// Scores and the online softmax are fp32; the probabilities go to the
// tensor cores in bf16 (as the TPU body casts p to v's dtype); the output
// accumulates in fp32 and is stored as bf16.
//
// What bounds it on the H100: tensor-core operations at the two large
// interpolation levels (L0: S=2560, d=40, 4*S*2S*d flops per row and head,
// 2.05 TFLOP per call, ~2.1 ms at 989 TFLOP/s; L1 0.26 ms), device-memory
// bytes at the two small ones (each of q, k, v, out moved once); at d=40
// also the exponentials, one per 160 flops of the products. The fp32 score
// matrix (51 GB at L0) must never exist: the kernel streams it.
//
// What the design (d <= 160) does about it: persistent blocks of three
// warpgroups, one an SM, walk work items of (query row, head, 128 query
// positions). Warpgroup 0 is the producer: one thread issues TMA loads of
// each item's Q and of each K and V tile into a ring of 2-4 stages guarded
// by mbarriers (full: the tile arrived; empty: both consumers are done with
// it; Q has its own pair), running ahead into the next item while the
// consumers finish one; the tile's source tensor and row (the anchor's row
// b for the first S keys, k's row r - 1 or the halo's row b for the rest)
// are computed from the tile index, so the (rows, 2S, C) concat is never
// materialised; setmaxnreg gives its registers to the
// consumers. Warpgroups 1 and 2 each own 64 query rows and run wgmma:
// S = Q K^T with both operands K-major in shared memory, and O += P V with P
// from registers (the score accumulator converted in place to bf16) and V
// MN-major through the instruction's transpose-B flag. Each loop step
// issues tile t's Q K^T and tile t-1's P V back to back, then runs tile t's
// softmax while P V is on the tensor cores; the two consumers take turns to
// issue (ping-pong on two named barriers), so one's softmax runs under the
// other's products. A consumer whose rows all lie past Sq only releases the
// stages. Head slices are 64-column
// slabs in 128-byte swizzled boxes of a 4-D tensor map over (d, H, S,
// rows): TMA zero-fills the columns past d, and Q K^T walks ceil(d/16)
// k-steps, the descriptor advanced 32 bytes a step inside the swizzle atom.
// Ragged key tails are masked to -inf, ragged query tails are not stored.

#include "hopper.cuh"

namespace {

using namespace hopper;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ----------------------------------------------------------------------------
// d <= 160: wgmma, a TMA ring and warp specialisation
// ----------------------------------------------------------------------------

constexpr int BM = 128;        // query positions per block: 64 per consumer warpgroup
constexpr int THREADS = 384;   // warpgroup 0 produces, 1 and 2 consume
constexpr int CONSUMERS = 256;
constexpr int SMEM_LIMIT = 232448;

// DP: the head dim rounded up to 16 (the template instance for every d of it)
template <int DP>
struct FlashCfg {
  static constexpr int SLABS = (DP + SLAB - 1) / SLAB;
  static constexpr int BN = DP <= 128 ? 128 : 64;  // keys per tile
  static constexpr int KSTEPS = DP / 16;
  static constexpr int Q_SLAB = BM * ROW_BYTES;
  static constexpr int KV_SLAB = BN * ROW_BYTES;
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int KV_BYTES = SLABS * KV_SLAB;  // K or V of one stage
  static constexpr int FIT = (SMEM_LIMIT - 1280 - Q_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  // 1024 bytes of slack to align the ring to the swizzle atom, 256 for barriers
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 256;
  // P V's width in slabs 0, 1, 2: 64, or the last slab's columns
  static constexpr int LAST = DP - SLAB * (SLABS - 1);
  static constexpr int NW0 = SLABS > 1 ? SLAB : LAST;
  static constexpr int NW1 = SLABS > 2 ? SLAB : LAST;
  static constexpr int NW2 = LAST;
  static_assert(NW0 + NW1 + NW2 >= 0, "");  // each is used by some instance
  static_assert(STAGES >= 2, "the ring needs two stages");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

struct FlashArgs {
  __nv_bfloat16* out;
  int Sq, Sk, H, d, frames, rows;
  float scale_log2;
};

// One work item: 128 query positions of one (row, head); consecutive items
// walk the query blocks, then the heads, then the rows.
struct Item {
  int qb, h, r, src0, src1, ntiles, tiles_per_half;
  int map0, map1;  // each half's source: 0 k and v, 1 the anchor, 2 the halo
};

template <int BN>
__device__ __forceinline__ Item item_at(const FlashArgs& a, int w) {
  Item it;
  const int qblocks = (a.Sq + BM - 1) / BM;
  it.qb = w % qblocks;
  it.h = (w / qblocks) % a.H;
  it.r = w / (qblocks * a.H);
  // key/value sources: sparse-causal (frames > 0) walks two halves of Sk
  // keys each, the anchor's row of the video, then k's row r - 1 or, for
  // the first frame, the halo's row of the video; otherwise one half over
  // the row's own keys
  it.src0 = it.r, it.src1 = it.r;
  it.map0 = it.map1 = 0;
  int halves = 1;
  if (a.frames > 0) {
    const int i = it.r % a.frames, b = it.r / a.frames;
    it.src0 = b, it.map0 = 1;
    if (i == 0)
      it.src1 = b, it.map1 = 2;
    else
      it.src1 = it.r - 1;
    halves = 2;
  }
  it.tiles_per_half = (a.Sk + BN - 1) / BN;
  it.ntiles = halves * it.tiles_per_half;
  return it;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_ka,
    const __grid_constant__ CUtensorMap tm_va, const __grid_constant__ CUtensorMap tm_kh,
    const __grid_constant__ CUtensorMap tm_vh, const FlashArgs a) {
  using Cfg = FlashCfg<DP>;
  constexpr int BN = Cfg::BN, SLABS = Cfg::SLABS, STAGES = Cfg::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_smem = (raw + 1023) & ~1023u;  // the swizzle atom is 1024 bytes
  const uint32_t kv_smem = q_smem + Cfg::Q_BYTES;  // stage s: K, then V
  const uint32_t bars = kv_smem + STAGES * 2 * Cfg::KV_BYTES;
  const uint32_t q_full = bars + 16 * STAGES, q_empty = q_full + 8;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int items = (a.Sq + BM - 1) / BM * a.H * a.rows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full, across work items ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int g = 0;  // tiles issued by this block
      for (int n = 0, w = blockIdx.x; w < items; ++n, w += gridDim.x) {
        const Item it = item_at<BN>(a, w);
        for (int t = 0; t < it.ntiles; ++t, ++g) {
          const int stage = g % STAGES;
          if (g >= STAGES) mbar_wait(empty(stage), ((g / STAGES) - 1) & 1);
          const int half = t / it.tiles_per_half;
          const int k0 = (t - half * it.tiles_per_half) * BN;
          const int src = half ? it.src1 : it.src0, m = half ? it.map1 : it.map0;
          const CUtensorMap* mk = m == 0 ? &tm_k : m == 1 ? &tm_ka : &tm_kh;
          const CUtensorMap* mv = m == 0 ? &tm_v : m == 1 ? &tm_va : &tm_vh;
          const uint32_t kd = kv_smem + stage * 2 * Cfg::KV_BYTES, vd = kd + Cfg::KV_BYTES;
          mbar_expect_tx(full(stage), 2 * Cfg::KV_BYTES);
          for (int sl = 0; sl < SLABS; ++sl) {
            tma_load_4d(kd + sl * Cfg::KV_SLAB, mk, full(stage), sl * SLAB, it.h, k0, src);
            tma_load_4d(vd + sl * Cfg::KV_SLAB, mv, full(stage), sl * SLAB, it.h, k0, src);
          }
          if (t == 0) {  // Q after the first K/V tile: the previous item's
                         // last Q K^T frees it
            if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
            mbar_expect_tx(q_full, Cfg::Q_BYTES);
            for (int sl = 0; sl < SLABS; ++sl)
              tma_load_4d(q_smem + sl * Cfg::Q_SLAB, &tm_q, q_full, sl * SLAB, it.h, it.qb * BM,
                          it.r);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = wg - 1, tw = threadIdx.x - 128 * wg;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, tig = lane & 3;
    const uint32_t q_mine = q_smem + c * 64 * ROW_BYTES;

    float o[DP / 2];
    float s[BN / 2];
    uint32_t p[BN / 16][4];
    float m_run[2], l_run[2], corr[2];

    auto qk = [&](int stage) {  // S = Q K^T, this warpgroup's 64 rows x BN keys
      const uint32_t kd = kv_smem + stage * 2 * Cfg::KV_BYTES;
      fence_regs<BN / 2>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Cfg::KSTEPS; ++kk)
        Gmma<BN>::ss(s, gmma_desc(q_mine + (kk / 4) * Cfg::Q_SLAB + (kk % 4) * 32),
                     gmma_desc(kd + (kk / 4) * Cfg::KV_SLAB + (kk % 4) * 32), kk > 0);
      wgmma_commit();
      fence_regs<BN / 2>(s);
    };
    auto pv = [&](int stage) {  // O += P V over the stage's V tile
      const uint32_t vd = kv_smem + stage * 2 * Cfg::KV_BYTES + Cfg::KV_BYTES;
      fence_regs_u<BN / 4>(&p[0][0]);
      fence_regs<DP / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        GmmaRs<Cfg::NW0>::rs(o, p[j], gmma_desc(vd + j * 16 * ROW_BYTES));
        if constexpr (SLABS > 1)
          GmmaRs<Cfg::NW1>::rs(o + 32, p[j], gmma_desc(vd + Cfg::KV_SLAB + j * 16 * ROW_BYTES));
        if constexpr (SLABS > 2)
          GmmaRs<Cfg::NW2>::rs(o + 64, p[j], gmma_desc(vd + 2 * Cfg::KV_SLAB + j * 16 * ROW_BYTES));
      }
      wgmma_commit();
      fence_regs<DP / 2>(o);
      fence_regs_u<BN / 4>(&p[0][0]);
    };
    // online softmax over tile t's scores (keys past Sk in its half masked):
    // s becomes exp2(s - max), m_run, l_run and corr move on
    auto softmax = [&](int kbase) {
      float mx[2] = {-INFINITY, -INFINITY};
      if (kbase + BN <= a.Sk) {  // every key of the tile is valid
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          s[i] *= a.scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int col = kbase + (i >> 2) * 8 + tig * 2 + (i & 1);
          s[i] = col < a.Sk ? s[i] * a.scale_log2 : -INFINITY;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m_run[hr], mx[hr]);
        corr[hr] = ex2(m_run[hr] - m_new);
        m_run[hr] = m_new;
        l_run[hr] *= corr[hr];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float e = ex2(s[i] - m_run[(i >> 1) & 1]);
        s[i] = e;
        l_run[(i >> 1) & 1] += e;
      }
    };
    // P in bf16: the accumulator layout of two n8 chunks is the A fragment
    // of one k16 step
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        p[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
        p[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
        p[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
        p[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    };

    int gt = 0;  // tiles consumed by this block
    for (int n = 0, w = blockIdx.x; w < items; ++n, w += gridDim.x) {
      const Item it = item_at<BN>(a, w);
      mbar_wait(q_full, n & 1);
      if (it.qb * BM + 64 * c >= a.Sq) {
        // every row of this warpgroup lies past Sq (only the second one's
        // can): release each tile and Q without computing
        for (int t = 0; t < it.ntiles; ++t, ++gt) {
          const int stage = gt % STAGES;
          mbar_wait(full(stage), (gt / STAGES) & 1);
          mbar_arrive(empty(stage));
        }
        mbar_arrive(q_empty);
        continue;
      }
      // ping-pong: where both warpgroups compute, they take turns to issue
      // their products, so that one's softmax runs under the other's wgmma.
      // Each has ntiles + 1 turns an item; the second lets the first go
      // first and skips its last hand-over, so both barriers balance.
      const bool pingpong = it.qb * BM + 64 < a.Sq;
      auto turn = [&]() {
        if (pingpong) asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c));
      };
      auto pass = [&](bool last) {
        if (pingpong && !(c == 1 && last)) asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c));
      };
      if (pingpong && c == 1) asm volatile("bar.arrive 3, 256;\n");
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
      m_run[0] = m_run[1] = -INFINITY;  // running max, scaled log2 units
      l_run[0] = l_run[1] = 0.f;        // this thread's partial row sums

      // tile 0: Q K^T, then its softmax
      int prev = gt % STAGES;
      mbar_wait(full(prev), (gt / STAGES) & 1);
      turn();
      qk(prev);
      pass(false);
      wgmma_wait<0>();
      fence_regs<BN / 2>(s);
      softmax(0);
      pack();
      ++gt;
      // each later tile: its Q K^T and the previous tile's P V back to back,
      // then its softmax while P V runs
      for (int t = 1; t < it.ntiles; ++t, ++gt) {
        const int stage = gt % STAGES;
        mbar_wait(full(stage), (gt / STAGES) & 1);
        turn();
        qk(stage);
        rescale();
        pv(prev);
        pass(false);
        wgmma_wait<1>();
        fence_regs<BN / 2>(s);
        softmax((t % it.tiles_per_half) * BN);
        wgmma_wait<0>();
        fence_regs<DP / 2>(o);
        mbar_arrive(empty(prev));
        pack();
        prev = stage;
      }
      mbar_arrive(q_empty);  // the item's last Q K^T is done
      rescale();
      turn();
      pv(prev);
      pass(true);
      wgmma_wait<0>();
      fence_regs<DP / 2>(o);
      mbar_arrive(empty(prev));

      // out = bf16(o / l), one division (div.rn.f32) a stored element, as
      // the TPU bodies divide; rows past Sq and columns past d are not stored
      float l0 = l_run[0], l1 = l_run[1];
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const int row0 = it.qb * BM + 64 * c + 16 * warp + g, row1 = row0 + 8;
      const size_t C = (size_t)a.H * a.d;
      __nv_bfloat16* ob = a.out + (size_t)it.r * a.Sq * C + (size_t)it.h * a.d;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        // o[4i..4i+3]: columns 8i + 2tig (+1) of rows row0 and row1
        const int col = (i / 8) * SLAB + (i % 8) * 8 + tig * 2;
        if (col < a.d) {
          if (row0 < a.Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + col) =
                __floats2bfloat162_rn(__fdiv_rn(o[4 * i], l0), __fdiv_rn(o[4 * i + 1], l0));
          if (row1 < a.Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
                __floats2bfloat162_rn(__fdiv_rn(o[4 * i + 2], l1), __fdiv_rn(o[4 * i + 3], l1));
        }
      }
    }
  }
}

// make_map over `rows` rows of (S, H*d) that lie row_stride elements apart:
// the anchor and halo operands, which may be rows of k itself
inline bool make_map_rows(CUtensorMap* map, const void* ptr, int d, int H, int S, int rows,
                          long long row_stride, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)rows};
  cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)H * d * 2, (cuuint64_t)row_stride * 2};
  cuuint32_t box[4] = {SLAB, 1, (cuuint32_t)box_rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The sparse-causal entry's borrowed keys and values: (k, v) rows of
// (S, H*d), `rows` of them, `stride` elements apart.
struct Borrowed {
  const void *k, *v;
  int rows;
  long long stride;
};

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const Borrowed& anchor,
                   const Borrowed& halo, void* out, int rows, int Sq, int Sk, int H, int d,
                   int frames, float scale, cudaStream_t stream) {
  using Cfg = FlashCfg<DP>;
  CUtensorMap mq, mk, mv, mka, mva, mkh, mvh;
  if (!make_map(&mq, q, d, H, Sq, rows, BM) || !make_map(&mk, k, d, H, Sk, rows, Cfg::BN) ||
      !make_map(&mv, v, d, H, Sk, rows, Cfg::BN) ||
      !make_map_rows(&mka, anchor.k, d, H, Sk, anchor.rows, anchor.stride, Cfg::BN) ||
      !make_map_rows(&mva, anchor.v, d, H, Sk, anchor.rows, anchor.stride, Cfg::BN) ||
      !make_map_rows(&mkh, halo.k, d, H, Sk, halo.rows, halo.stride, Cfg::BN) ||
      !make_map_rows(&mvh, halo.v, d, H, Sk, halo.rows, halo.stride, Cfg::BN))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  // persistent blocks, one an SM (the ring takes most of its shared memory)
  const int sms = sm_count();
  const long long items = (long long)((Sq + BM - 1) / BM) * H * rows;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int grid = (int)(items < sms ? items : sms);
  const FlashArgs a{static_cast<__nv_bfloat16*>(out), Sq, Sk, H, d, frames, rows,
                    scale * 1.4426950408889634f};
  flash_kernel<DP><<<grid, THREADS, Cfg::SMEM, stream>>>(mq, mk, mv, mka, mva, mkh, mvh, a);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const Borrowed& anchor,
                     const Borrowed& halo, void* out, int rows, int Sq, int Sk, int H, int d,
                     int frames, float scale, cudaStream_t st) {
  if (rows < 1 || rows > 65535 || Sq < 1 || Sk < 1 || H < 1 || H > 65535 || d < 8 || d % 8 ||
      d > 160)
    return cudaErrorInvalidValue;
  switch ((d + 15) / 16 * 16) {
#define FLASH_CASE(DP) \
  case DP:             \
    return launch<DP>(q, k, v, anchor, halo, out, rows, Sq, Sk, H, d, frames, scale, st);
    FLASH_CASE(16) FLASH_CASE(32) FLASH_CASE(48) FLASH_CASE(64) FLASH_CASE(80)
    FLASH_CASE(96) FLASH_CASE(112) FLASH_CASE(128) FLASH_CASE(144) FLASH_CASE(160)
#undef FLASH_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------------
// d = 512: the f4 VAE decoder's mid attention, one head over all 163,840
// latent positions of a 320x512 frame (4*S^2*d = 5.5e13 flops per frame,
// 56 ms at 989 TFLOP/s; the fp32 scores would be 107 GB per frame; one
// exponential per 2048 flops, so the special-function unit does not bind).
//
// A 64-row fp32 output tile of 512 columns is 256 registers a thread in one
// warpgroup, above the limit, so a block of two warpgroups ("consumers")
// owns 64 queries and splits d: consumer c (0, 1) owns output columns
// 256c.. (an m64n256 fp32 accumulator, 128 registers a thread, as four
// m64n64 wgmma a k-step). Each tile of 32 keys:
//   - each consumer computes its half-d partial of S = Q K^T on wgmma, Q
//     (64 x 512, loaded once) and the K tile both K-major in shared memory
//     (m64n32k16: 47 B of shared-memory reads a KFLOP, above the 31 of a
//     64-key tile, but a 64-key tile leaves room for one K and one V slot
//     only, and no second score tile in registers);
//   - both write their partials to shared memory and meet at a named
//     barrier of the two consumer warpgroups (not the block); each adds the
//     other's partial to its own (fp32 addition commutes, so both hold the
//     same scores) and takes the same online-softmax step: s = dot *
//     scale in log2 units, m_new = max(m, rowmax s), corr = 2^(m - m_new),
//     p = 2^(s - m_new), l = l corr + sum p;
//   - each rescales its O half by corr and adds bf16(p) V over its 256
//     columns on wgmma, P from registers (the score accumulator converted in
//     place to bf16 A fragments), V MN-major through the transpose-B flag.
// The steps overlap across tiles: tile t+1's Q K^T is issued before tile
// t's softmax and runs under it, and tile t+1's exchange runs under tile
// t's P V; the partials alternate between two buffers, so one barrier a
// tile suffices. out = bf16(acc / l), a division as in the TPU body; rows
// past Sq are not stored. Shared memory: Q 64 KB, two K and two V slots of
// 32 KB each and two buffers of both consumers' 8 KB partials, 225 KB.
//
// K and V are what bounds a 64-query block: every block reads all of its
// frame's K and V (335 MB a frame), 6.9 TB of L2-to-SM traffic per 8-frame
// decode. Blocks on W_CLUSTER = 2 neighbouring query tiles of the same
// (frame, head) run as one thread-block cluster: the CTA of rank r loads
// 8/W_CLUSTER of each tile's eight 64-column slabs and multicasts them to
// every CTA of the cluster, so each L2 read serves W_CLUSTER blocks (4
// timed alike on the H100, in a copy built with W_CLUSTER = 4). A K slot is
// refilled once both consumers of every CTA of the cluster passed their
// exchange (one remote mbarrier arrival per CTA), a V slot once each
// consumer of every CTA finished its P V (one arrival per consumer); a CTA
// past the last query tile still takes part in the loads, computes on the
// zeros TMA fills in for its queries, and stores nothing.
// ----------------------------------------------------------------------------

constexpr int WD = 512, WBQ = 64;       // head dim, queries a block
constexpr int WSLABS = WD / SLAB;       // 64-column slabs of a row
constexpr int W_QSLAB = WBQ * ROW_BYTES;  // one slab of Q's rows
constexpr int W_QTILE = WSLABS * W_QSLAB;  // Q: 64 KB
// two warpgroups and no producer warp: a ninth warp would put three warps
// on one of the SM's four register-file quarters and cap every thread at
// 168 registers, below what the accumulator and two score tiles need (ptxas
// spilled there); thread 0 issues the K loads and thread 128 the V loads
// between their products
constexpr int W_THREADS = 256;
constexpr int W_KEYS = 32, W_SLOTS = 2;  // keys a tile, ring slots of K and of V
constexpr int W_CLUSTER = 2;             // CTAs that share each K and V tile by multicast

constexpr int W_KSLAB = W_KEYS * ROW_BYTES;        // one slab of a K or V tile
constexpr int W_KTILE = WSLABS * W_KSLAB;          // a K or V tile
constexpr int W_XCH = 128 * (W_KEYS / 2) * 4;      // one consumer's partial scores
// 1 KB of slack to align the tiles to the swizzle atom, Q, the K and V
// slots, two buffers of both consumers' partials, the mbarriers
constexpr int W_SMEM = 1024 + W_QTILE + 2 * W_SLOTS * W_KTILE + 4 * W_XCH + 128;
static_assert(W_SMEM <= SMEM_LIMIT, "shared memory");
static_assert(1 + 4 * W_SLOTS <= 16, "mbarriers");

struct WideArgs {
  __nv_bfloat16* out;
  int Sq, Sk, H;
  float scale_log2;
};

__global__ void __launch_bounds__(W_THREADS, 1) flash_d512_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const WideArgs a) {
  constexpr int BK = W_KEYS, NS = W_SLOTS, CL = W_CLUSTER;
  constexpr int SPC = WSLABS / CL;  // slabs of each K and V tile this CTA loads for the cluster
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_smem = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_smem = q_smem + W_QTILE;        // slot i at k_smem + i * W_KTILE
  const uint32_t v_smem = k_smem + NS * W_KTILE;
  const uint32_t xch = v_smem + NS * W_KTILE;   // buffer j of consumer c at xch + (2j + c) * W_XCH
  const uint32_t bars = xch + 4 * W_XCH;
  const uint32_t q_full = bars;
  auto k_full = [&](int i) { return bars + 8 * (1 + i); };
  auto k_empty = [&](int i) { return bars + 8 * (1 + NS + i); };
  auto v_full = [&](int i) { return bars + 8 * (1 + 2 * NS + i); };
  auto v_empty = [&](int i) { return bars + 8 * (1 + 3 * NS + i); };
  const int qt = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int ntiles = (a.Sk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < NS; ++i) {
      mbar_init(k_full(i), 1);
      mbar_init(v_full(i), 1);
      mbar_init(k_empty(i), CL);      // one arrival from each CTA of the cluster
      mbar_init(v_empty(i), 2 * CL);  // one from each consumer of each CTA
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  {
    // ---- each warpgroup ("consumer"): half of d ----
    const int c = threadIdx.x / 128, tw = threadIdx.x % 128;
    const int warp = tw >> 5, lane = tw & 31, g = lane >> 2, tig = lane & 3;
    const uint32_t q_mine = q_smem + c * (WSLABS / 2) * W_QSLAB;
    // float4 j of this thread's partials at (j * 128 + tw) * 16: conflict-free
    const uint32_t x_mine = xch + c * W_XCH + tw * 16;
    const uint32_t x_theirs = xch + (1 - c) * W_XCH + tw * 16;

    // K tile t into slot t % NS for the cluster (thread 0) once every CTA's
    // consumers released the slot's previous tile; the same for V (thread
    // 128): this CTA multicasts its SPC slabs of the tile to the cluster
    const uint32_t rank = cluster_ctarank();
    const uint16_t mask = (uint16_t)((1u << CL) - 1);
    auto load = [&](const CUtensorMap* map, uint32_t base, uint32_t full, uint32_t empty, int t) {
      if (t >= NS) mbar_wait(empty, (t / NS - 1) & 1);
      mbar_expect_tx(full, W_KTILE);  // every CTA's slabs land here
      const uint32_t dst = base + (t % NS) * W_KTILE;
      for (int sl = rank * SPC; sl < (int)(rank + 1) * SPC; ++sl)
        tma_load_4d_multicast(dst + sl * W_KSLAB, map, full, sl * SLAB, h, t * BK, r, mask);
    };
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, W_QTILE);
      for (int sl = 0; sl < WSLABS; ++sl)
        tma_load_4d(q_smem + sl * W_QSLAB, &tm_q, q_full, sl * SLAB, h, qt * WBQ, r);
      for (int t = 0; t < NS && t < ntiles; ++t) load(&tm_k, k_smem, k_full(t), k_empty(t), t);
    }
    if (threadIdx.x == 128) load(&tm_v, v_smem, v_full(0), v_empty(0), 0);

    float o[WD / 4];  // columns 256c + 64i + 8j + 2tig (+1) at o[32i + 4j + e]
    float s[BK / 2], sn[BK / 2];  // tile t's scores, tile t + 1's partial
    uint32_t p[BK / 16][4];
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < WD / 4; ++i) o[i] = 0.f;

    // issue this half of d's partial S = Q K^T of tile t into d over 16
    // k-steps; the caller waits. The descriptors (a descriptor counts
    // 16-byte units) are made opaque each tile so that none is held across
    // the loop.
    auto qk = [&](float* d, int t) {
      const int i = t % NS;
      uint32_t qa = q_mine, ka = k_smem + i * W_KTILE + c * (WSLABS / 2) * W_KSLAB;
      asm volatile("" : "+r"(qa), "+r"(ka));
      const uint64_t dq = gmma_desc(qa), dk = gmma_desc(ka);
      mbar_wait(k_full(i), (t / NS) & 1);
      fence_regs<BK / 2>(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WD / 2 / 16; ++kk)
        Gmma<BK>::ss(d, dq + (((kk / 4) * W_QSLAB + (kk % 4) * 32) >> 4),
                     dk + (((kk / 4) * W_KSLAB + (kk % 4) * 32) >> 4), kk > 0);
      wgmma_commit();
    };
    // once tile t's partial is in d: add the other consumer's (fp32
    // addition commutes, so both hold the same scores), through buffer t % 2
    // of each; after the barrier both are done with K tile t
    auto exchange = [&](float* d, int t) {
      fence_regs<BK / 2>(d);
      const uint32_t off = (t & 1) * 2 * W_XCH;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(x_mine + off + j * 128 * 16),
                     "f"(d[4 * j]), "f"(d[4 * j + 1]), "f"(d[4 * j + 2]), "f"(d[4 * j + 3])
                     : "memory");
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (c == 0 && tw < CL && t + NS < ntiles) mbar_arrive_cluster(k_empty(t % NS), tw);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float x0, x1, x2, x3;
        asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                     : "=f"(x0), "=f"(x1), "=f"(x2), "=f"(x3)
                     : "r"(x_theirs + off + j * 128 * 16)
                     : "memory");
        d[4 * j] += x0;
        d[4 * j + 1] += x1;
        d[4 * j + 2] += x2;
        d[4 * j + 3] += x3;
      }
    };
    // the online-softmax step of tile t on its scores d, in log2 units:
    // d[e] is key 8(e/4) + 2tig + e%2 of the tile, row g + 8((e/2)%2) of
    // this warp's 16; keys past Sk masked. P in bf16 into p (the
    // accumulator layout of two n8 chunks is the A fragment of one k16
    // step); O rescaled by corr unless no row of the warp moved its max
    // (a product by 1 changes nothing)
    auto softmax = [&](float* d, int t) {
      const int kbase = t * BK;
      float mx[2] = {-INFINITY, -INFINITY};
      if (kbase + BK <= a.Sk) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          d[e] *= a.scale_log2;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], d[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int col = kbase + (e >> 2) * 8 + tig * 2 + (e & 1);
          d[e] = col < a.Sk ? d[e] * a.scale_log2 : -INFINITY;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], d[e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m_run[hr], mx[hr]);
        corr[hr] = ex2(m_run[hr] - m_new);
        m_run[hr] = m_new;
        l_run[hr] *= corr[hr];
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        const float pe = ex2(d[e] - m_run[(e >> 1) & 1]);
        d[e] = pe;
        l_run[(e >> 1) & 1] += pe;
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        p[j][0] = pack_bf16(d[8 * j + 0], d[8 * j + 1]);
        p[j][1] = pack_bf16(d[8 * j + 2], d[8 * j + 3]);
        p[j][2] = pack_bf16(d[8 * j + 4], d[8 * j + 5]);
        p[j][3] = pack_bf16(d[8 * j + 6], d[8 * j + 7]);
      }
      if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
        for (int e = 0; e < WD / 4; ++e) o[e] *= corr[(e >> 1) & 1];
      }
    };
    // issue O += P V of tile t over this half's 256 columns, four 64-column
    // slabs, P from registers, V MN-major; the caller waits
    auto pv = [&](int t) {
      const int i = t % NS;
      uint32_t va = v_smem + i * W_KTILE + c * (WSLABS / 2) * W_KSLAB;
      asm volatile("" : "+r"(va));
      const uint64_t dv = gmma_desc(va);
      mbar_wait(v_full(i), (t / NS) & 1);
      fence_regs_u<BK / 4>(&p[0][0]);
      fence_regs<WD / 4>(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int sl = 0; sl < 4; ++sl)
          GmmaRs<64>::rs(o + 32 * sl, p[j], dv + ((sl * W_KSLAB + j * 16 * ROW_BYTES) >> 4));
      wgmma_commit();
    };

    mbar_wait(q_full, 0);
    qk(s, 0);
    wgmma_wait<0>();
    exchange(s, 0);
    // each step issues tile t + 1's Q K^T, runs tile t's softmax under it,
    // issues tile t's P V, and exchanges tile t + 1's partials under that
    for (int t = 0; t + 1 < ntiles; ++t) {
      // the slots of K tile t + NS and V tile t + 1 were released a step ago
      if (threadIdx.x == 0 && t + NS < ntiles)
        load(&tm_k, k_smem, k_full(t % NS), k_empty(t % NS), t + NS);
      if (threadIdx.x == 128)
        load(&tm_v, v_smem, v_full((t + 1) % NS), v_empty((t + 1) % NS), t + 1);
      qk(sn, t + 1);
      softmax(s, t);
      pv(t);
      wgmma_wait<1>();  // Q K^T of tile t + 1 (P V of tile t may still run)
      exchange(sn, t + 1);
      wgmma_wait<0>();
      fence_regs<WD / 4>(o);
      fence_regs_u<BK / 4>(&p[0][0]);
      if (tw < CL && t + NS < ntiles) mbar_arrive_cluster(v_empty(t % NS), tw);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) s[e] = sn[e];
    }
    softmax(s, ntiles - 1);
    pv(ntiles - 1);
    wgmma_wait<0>();
    fence_regs<WD / 4>(o);
    fence_regs_u<BK / 4>(&p[0][0]);

    // out = bf16(acc / l); rows past Sq (and every row of a CTA past the
    // last query tile) are not stored
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 1);
      l_run[hr] += __shfl_xor_sync(0xffffffffu, l_run[hr], 2);
    }
    const int row0 = qt * WBQ + 16 * warp + g, row1 = row0 + 8;
    const size_t C = (size_t)a.H * WD;
    __nv_bfloat16* ob = a.out + (size_t)r * a.Sq * C + (size_t)h * WD + c * (WD / 2);
#pragma unroll
    for (int e = 0; e < WD / 2 / 8; ++e) {
      // o[4e..4e+3]: columns 8e + 2tig (+1) of this half, rows row0 and row1
      const int col = e * 8 + tig * 2;
      if (row0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * C + col) =
            __floats2bfloat162_rn(o[4 * e] / l_run[0], o[4 * e + 1] / l_run[0]);
      if (row1 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
            __floats2bfloat162_rn(o[4 * e + 2] / l_run[1], o[4 * e + 3] / l_run[1]);
    }
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster_sync();
}

cudaError_t launch_d512(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Sk, int H, float scale, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, WD, H, Sq, B, WBQ) || !make_map(&mk, k, WD, H, Sk, B, W_KEYS) ||
      !make_map(&mv, v, WD, H, Sk, B, W_KEYS))
    return cudaErrorNotSupported;
  cudaError_t err =
      cudaFuncSetAttribute(flash_d512_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (err != cudaSuccess) return err;
  // one CTA a query tile, the tiles rounded up to whole clusters
  const int qtiles = (Sq + WBQ - 1) / WBQ;
  const dim3 grid((qtiles + W_CLUSTER - 1) / W_CLUSTER * W_CLUSTER, H, B);
  WideArgs a{static_cast<__nv_bfloat16*>(out), Sq, Sk, H, scale * 1.4426950408889634f};
  void* args[] = {&mq, &mk, &mv, &a};
  return launch_cluster((const void*)flash_d512_kernel, grid, W_THREADS, W_SMEM, W_CLUSTER, st,
                        args);
}

}  // namespace

// q, out: (B, Sq, H*512); k, v: (B, Sk, H*512); bf16, contiguous, 16-byte
// aligned; d must be 512. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel cannot take.
extern "C" int flash_attention_d512_bf16(const void* q, const void* k, const void* v, void* out,
                                         int B, int Sq, int Sk, int H, int d, float scale,
                                         void* stream) {
  if (d != WD || B < 1 || B > 65535 || Sq < 1 || Sk < 1 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_d512(q, k, v, out, B, Sq, Sk, H, scale, static_cast<cudaStream_t>(stream));
}

// q, k, v, out: (BF, S, H*d) bf16, contiguous, 16-byte aligned; BF a
// multiple of F. Keys/values of row r = b F + i: concat(anchor row b, row
// r - 1 for i > 0 or halo row b for i = 0). ka, va (kh, vh): BF / F rows of
// (S, H*d), row b at b * anchor_stride (halo_stride) elements, 16-byte
// aligned, strides multiples of 8 elements. Requires d % 8 == 0, d <= 160.
// Returns cudaGetLastError().
extern "C" int flash_sparse_causal_bf16(const void* q, const void* k, const void* v,
                                        const void* ka, const void* va, const void* kh,
                                        const void* vh, void* out, int BF, int F, int S, int H,
                                        int d, long long anchor_stride, long long halo_stride,
                                        float scale, void* stream) {
  if (F < 1 || BF % F != 0 || anchor_stride < (long long)S * H * d ||
      halo_stride < (long long)S * H * d || anchor_stride % 8 || halo_stride % 8)
    return (int)cudaErrorInvalidValue;
  const Borrowed anchor{ka, va, BF / F, anchor_stride}, halo{kh, vh, BF / F, halo_stride};
  return (int)dispatch(q, k, v, anchor, halo, out, BF, S, S, H, d, F, scale,
                       static_cast<cudaStream_t>(stream));
}

// q, out: (B, Sq, H*d); k, v: (B, Sk, H*d); bf16, contiguous, 16-byte
// aligned. Requires d % 8 == 0, d <= 160. Returns cudaGetLastError().
extern "C" int flash_attention_kv_bf16(const void* q, const void* k, const void* v, void* out,
                                       int B, int Sq, int Sk, int H, int d, float scale,
                                       void* stream) {
  const Borrowed unused{k, v, B, (long long)Sk * H * d};  // no sparse half reads it
  return (int)dispatch(q, k, v, unused, unused, out, B, Sq, Sk, H, d, 0, scale,
                       static_cast<cudaStream_t>(stream));
}
