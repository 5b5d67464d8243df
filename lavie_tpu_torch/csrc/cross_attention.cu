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
//       resident, so no online rescale), e_j / sum_j e_j (a division
//       rounded to nearest, as the TPU body divides: csrc/cross_attn.cuh's
//       div_by_sum in the wgmma body, div.rn.f32 in cross_long_kernel),
//       rounded to bf16;
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
//   L <= 256 but for d > 128 past 160 keys (cross_kernel<DP, NK>, on the
//     body in csrc/cross_attn.cuh that csrc/cross_head.cu and
//     csrc/cross_block.cu share at 80 keys): the score tile is NK keys wide,
//     80 for the 77 text tokens, 160 for 80 < L <= 160 (the image path's 77
//     text + 77 mapped keys), 256 above at d <= 128; K and V are loaded NK
//     rows deep. Two consumer warpgroups take the block's items in turn (one
//     at 256 keys, in a block of 256 threads: its 128 score registers a
//     thread do not fit under the 168 a block of 384 allows), on wgmma like
//     the flash body: S = Q K^T (m64nNKk16, both operands K-major
//     in the swizzled boxes), the softmax in the accumulator registers with
//     quad shuffles and ex2, then O = P V with P from registers and V an
//     MN-major B operand, so V needs no transpose and no ldmatrix runs at
//     all. The output tile goes back into its query tile's stage, laid out
//     as the box, and leaves by one TMA store of whole rows, as coalesced as
//     the loads; the stage returns to the producer once a later store shows
//     it read. Each consumer holds up to two stages, so the ring needs two
//     a consumer warpgroup; the plan gives every instance four or more.
//   160 < L <= 256 at d > 128 (cross_long_kernel<144|160>, mma.sync): K and
//     V alone take 196,608 bytes 256 rows deep, which leaves room for one
//     query tile and not the wgmma body's four. Each warp owns 16 queries on
//     mma.sync m16n8k16, Q and K fragments by ldmatrix, V by ldmatrix.trans
//     (the swizzle keeps the eight rows of each ldmatrix in distinct banks),
//     P straight from the score registers, and stores from registers.
// The next tiles' loads are in flight meanwhile.

#include "cross_attn.cuh"
#include "mma_tiles.cuh"

namespace {

using namespace xattn;
using tiles::mma16816;

constexpr int LONG_KEYS = 256;  // keys a thread's scores cover in cross_long_kernel
constexpr int WIDE_MAX_D = 128;  // head dims of the 256-key wgmma body: K and V in two slabs

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

// ---- L <= NK keys: wgmma ---------------------------------------------------

template <int DP, int NK>
__global__ void __launch_bounds__(threads_at<NK>(), 1) cross_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
    const CrossArgs a) {
  cross_body<DP, NK>(&tm_q, &tm_k, &tm_v, &tm_o, a);
}

// ---- 160 < L <= 256 at d > 128: mma.sync -----------------------------------

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
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
      sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
    }

    // out = P V, P = e / sum from the score registers, V by ldmatrix.trans
    float o[DP / 8][4];
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < LP / 16; ++j) {
      if (j * 16 < a.kv_rows) {
        const uint32_t pa[4] = {pack_bf16(sc[2 * j][0] / sum[0], sc[2 * j][1] / sum[0]),
                                pack_bf16(sc[2 * j][2] / sum[1], sc[2 * j][3] / sum[1]),
                                pack_bf16(sc[2 * j + 1][0] / sum[0], sc[2 * j + 1][1] / sum[0]),
                                pack_bf16(sc[2 * j + 1][2] / sum[1], sc[2 * j + 1][3] / sum[1])};
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

// the score tile's width of the wgmma body for L keys at head dim D, or 0
// for cross_long_kernel
inline int key_width(int L, int D) {
  if (L <= KEYS) return KEYS;
  if (L <= MID_KEYS) return MID_KEYS;
  return D <= WIDE_MAX_D ? WIDE_KEYS : 0;
}

template <int DP, int NK>
cudaError_t launch_wgmma(const CUtensorMap (&m)[4], const CrossArgs& a, int grid, int smem,
                         cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(cross_kernel<DP, NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cross_kernel<DP, NK><<<grid, threads_at<NK>(), smem, st>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const CrossArgs& a, int B,
                   int grid, int smem, cudaStream_t st) {
  constexpr int SLABS = Cfg<DP>::SLABS;
  const int nk = key_width(a.L, a.D);
  // the wgmma body holds up to two stages a consumer warpgroup
  const int consumers = nk == WIDE_KEYS ? consumers_at<WIDE_KEYS>() : CW;
  if (smem < smem_need(SLABS, a.kv_rows, a.stages, a.tile) || (nk && a.stages < 2 * consumers))
    return cudaErrorInvalidValue;
  CUtensorMap m[4];
  if (!make_maps(&m[0], &m[1], &m[2], &m[3], q, k, v, a, B)) return cudaErrorNotSupported;
  if (nk == KEYS) return launch_wgmma<DP, KEYS>(m, a, grid, smem, st);
  if (nk == MID_KEYS) return launch_wgmma<DP, MID_KEYS>(m, a, grid, smem, st);
  if constexpr (DP <= WIDE_MAX_D) {
    return launch_wgmma<DP, WIDE_KEYS>(m, a, grid, smem, st);
  } else {
    cudaError_t err = cudaFuncSetAttribute(cross_long_kernel<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cross_long_kernel<DP><<<grid, LONG_THREADS, smem, st>>>(m[0], m[1], m[2], a);
    return cudaGetLastError();
  }
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

// div_by_sum elementwise, for the test that holds it to e / sum
__global__ void div_by_sum_kernel(const float* __restrict__ e, const float* __restrict__ sum,
                                  float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = div_by_sum(e[i], sum[i], rcp_of_sum(sum[i]));
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
  // the wgmma body loads K and V NK rows deep, TMA zero-filling the rows
  // past L, so that P V (over all NK rows of V) multiplies p = 0 by zeros
  // and never by what lies past the V slab
  const int nk = key_width(L, D);
  const int kv_rows = nk ? nk : (L + 15) / 16 * 16;
  const CrossArgs a{static_cast<bf16*>(out), S, H, D, L, kv_rows, tile, stages, (int)items,
                    scale * 1.4426950408889634f};
  return (int)dispatch(q, k, v, a, B, grid, smem, static_cast<cudaStream_t>(stream));
}

// out[i] = div_by_sum(e[i], sum[i]) over n fp32 pairs (e = 0 or a normal
// number <= 1, 1 <= sum), the softmax's division alone, for the test that
// holds it to e / sum. Returns cudaGetLastError().
extern "C" int div_by_sum_f32(const void* e, const void* sum, void* out, int n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  div_by_sum_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<const float*>(sum), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
