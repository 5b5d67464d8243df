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
// consumers finish one; the tile's source row (r0 for the first S keys, rp
// for the rest) is computed from the tile index, so the (rows, 2S, C)
// concat is never materialised; setmaxnreg gives its registers to the
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
};

template <int BN>
__device__ __forceinline__ Item item_at(const FlashArgs& a, int w) {
  Item it;
  const int qblocks = (a.Sq + BM - 1) / BM;
  it.qb = w % qblocks;
  it.h = (w / qblocks) % a.H;
  it.r = w / (qblocks * a.H);
  // key/value source rows: sparse-causal (frames > 0) walks two halves of
  // Sk keys each, frame 0 of the video then frame i-1; otherwise one half
  // over the row's own keys
  it.src0 = it.r, it.src1 = it.r;
  int halves = 1;
  if (a.frames > 0) {
    const int i = it.r % a.frames;
    it.src0 = it.r - i;
    it.src1 = i == 0 ? it.r : it.r - 1;
    halves = 2;
  }
  it.tiles_per_half = (a.Sk + BN - 1) / BN;
  it.ntiles = halves * it.tiles_per_half;
  return it;
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1) flash_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const FlashArgs a) {
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
          const int src = half ? it.src1 : it.src0;
          const uint32_t kd = kv_smem + stage * 2 * Cfg::KV_BYTES, vd = kd + Cfg::KV_BYTES;
          mbar_expect_tx(full(stage), 2 * Cfg::KV_BYTES);
          for (int sl = 0; sl < SLABS; ++sl) {
            tma_load_4d(kd + sl * Cfg::KV_SLAB, &tm_k, full(stage), sl * SLAB, it.h, k0, src);
            tma_load_4d(vd + sl * Cfg::KV_SLAB, &tm_v, full(stage), sl * SLAB, it.h, k0, src);
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

      // normalise and store; rows past Sq and columns past d are not stored
      float l0 = l_run[0], l1 = l_run[1];
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
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
                __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
          if (row1 < a.Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * C + col) =
                __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
        }
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int rows, int Sq,
                   int Sk, int H, int d, int frames, float scale, cudaStream_t stream) {
  using Cfg = FlashCfg<DP>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, d, H, Sq, rows, BM) || !make_map(&mk, k, d, H, Sk, rows, Cfg::BN) ||
      !make_map(&mv, v, d, H, Sk, rows, Cfg::BN))
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
  flash_kernel<DP><<<grid, THREADS, Cfg::SMEM, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int rows, int Sq,
                     int Sk, int H, int d, int frames, float scale, cudaStream_t st) {
  if (rows < 1 || rows > 65535 || Sq < 1 || Sk < 1 || H < 1 || H > 65535 || d < 8 || d % 8 ||
      d > 160)
    return cudaErrorInvalidValue;
  switch ((d + 15) / 16 * 16) {
#define FLASH_CASE(DP) \
  case DP:             \
    return launch<DP>(q, k, v, out, rows, Sq, Sk, H, d, frames, scale, st);
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
