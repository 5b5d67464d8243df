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
//            the scores, not on q);
//   p = exact max-subtracted softmax over j in one pass (the whole kv is
//       resident, so no online rescale), rounded to bf16;
//   out = p v accumulated in fp32, rounded once to bf16.
// Layout: q, out (B, S, H, D) and k, v (B, L, H, D), as the projections
// produce them; D a multiple of 8 up to 160; any S (the last tile is
// ragged).
//
// What bounds it on the H100: device-memory bytes. At the base L0 level
// (q of 2 x 40,960 x 8 x 40) a call reads q and writes out once, 105 MB,
// 0.031 ms at 3.35 TB/s, while its 4*B*H*S*L*D = 8 GFLOP take 0.008 ms at
// 989 TFLOP/s.
//
// What the design does about it: one block per (128 queries, head, batch).
// The head's keys (L x D, rows padded to 80 or 256, columns to a multiple of
// 16 with zeros) and its values, transposed to (D, L), live in shared memory
// whole (24.6 KB each at L = 77, D = 160), next to the block's q tile. Each
// of the 8 warps owns 16 queries: q fragments by ldmatrix, all scores of a
// row in registers (mma.sync m16n8k16, fp32), the softmax with quad
// shuffles, P.V on the tensor cores with P straight from the score
// registers, and the output stored from registers. Only q, k, v and out
// touch device memory; the kv is read once per block from L2.

#include "mma_tiles.cuh"

namespace {

using namespace tiles;
constexpr int QT = 128;  // queries per block, 16 per warp

template <int DP, int LP>
struct Cross {
  static constexpr int KLD = DP + 8, VLD = LP + 8;
  static constexpr size_t SMEM = ((size_t)LP * KLD + (size_t)DP * VLD + (size_t)QT * KLD) * 2;
};

template <int DP, int LP>
__global__ void __launch_bounds__(THREADS) cross_kernel(const bf16* __restrict__ q,
                                                       const bf16* __restrict__ k,
                                                       const bf16* __restrict__ v,
                                                       bf16* __restrict__ out, int S, int H,
                                                       int D, int L, float scale) {
  constexpr int KLD = Cross<DP, LP>::KLD, VLD = Cross<DP, LP>::VLD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // (LP, KLD)
  bf16* Vt = Ks + LP * KLD;                  // (DP, VLD)
  bf16* Qs = Vt + DP * VLD;                  // (QT, KLD)
  const int s0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const size_t row = (size_t)H * D;  // elements between consecutive tokens
  const bf16* kb = k + (size_t)b * L * row + (size_t)h * D;
  const bf16* vb = v + (size_t)b * L * row + (size_t)h * D;
  const bf16* qb = q + (size_t)b * S * row + (size_t)h * D;

  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int idx = threadIdx.x; idx < LP * (DP / 8); idx += THREADS) {
    const int l = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
    const bool in = l < L && c < D;
    *reinterpret_cast<uint4*>(Ks + l * KLD + c) =
        in ? *reinterpret_cast<const uint4*>(kb + l * row + c) : zero4;
    const uint4 vv = in ? *reinterpret_cast<const uint4*>(vb + l * row + c) : zero4;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) Vt[(c + e) * VLD + l] = ve[e];
  }
  for (int idx = threadIdx.x; idx < QT * (DP / 8); idx += THREADS) {
    const int r = idx / (DP / 8), c = (idx % (DP / 8)) * 8;
    *reinterpret_cast<uint4*>(Qs + r * KLD + c) =
        s0 + r < S && c < D ? *reinterpret_cast<const uint4*>(qb + (s0 + r) * row + c) : zero4;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  if (s0 + warp * 16 >= S) return;  // this warp's rows are all past the end
  float s[LP / 8][4];
#pragma unroll
  for (int nt = 0; nt < LP / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t qa[4];
    ldsm_x4(qa, Qs + (warp * 16 + (lane & 15)) * KLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nt = 0; nt < LP / 8; ++nt) {
      const bf16* kr = Ks + (nt * 8 + g) * KLD + kk * 16 + tig * 2;
      mma16816(s[nt], qa, ld32(kr), ld32(kr + 8));
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < LP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = nt * 8 + tig * 2 + (e & 1) < L ? s[nt][e] * scale : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
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
      s[nt][e] = expf(s[nt][e] - mx[e >> 1]);
      sum[e >> 1] += s[nt][e];
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 1);
    sum[hr] += __shfl_xor_sync(0xffffffffu, sum[hr], 2);
  }
  float o[DP / 8][4];
#pragma unroll
  for (int nt = 0; nt < DP / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
  for (int j = 0; j < LP / 16; ++j) {
    const uint32_t pa[4] = {pack_bf16(s[2 * j][0] / sum[0], s[2 * j][1] / sum[0]),
                            pack_bf16(s[2 * j][2] / sum[1], s[2 * j][3] / sum[1]),
                            pack_bf16(s[2 * j + 1][0] / sum[0], s[2 * j + 1][1] / sum[0]),
                            pack_bf16(s[2 * j + 1][2] / sum[1], s[2 * j + 1][3] / sum[1])};
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      const bf16* vr = Vt + (nt * 8 + g) * VLD + j * 16 + tig * 2;
      mma16816(o[nt], pa, ld32(vr), ld32(vr + 8));
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = s0 + warp * 16 + g + hr * 8;
    if (r >= S) continue;
    bf16* orow = out + (size_t)b * S * row + (size_t)r * row + (size_t)h * D;
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt)
      if (nt * 8 < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + tig * 2) =
            __floats2bfloat162_rn(o[nt][2 * hr], o[nt][2 * hr + 1]);
  }
}

template <int DP, int LP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                   int D, int L, float scale, cudaStream_t st) {
  cudaError_t err = prepare(cross_kernel<DP, LP>, Cross<DP, LP>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + QT - 1) / QT, H, B);
  cross_kernel<DP, LP><<<grid, THREADS, Cross<DP, LP>::SMEM, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), S, H, D, L, scale);
  return cudaGetLastError();
}

template <int LP>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                     int D, int L, float scale, cudaStream_t st) {
  switch ((D + 15) / 16) {
    case 1: return launch<16, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    case 2: return launch<32, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    case 3: return launch<48, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    case 4: return launch<64, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    case 5: return launch<80, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    case 6: return launch<96, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    case 7: return launch<112, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    case 8: return launch<128, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    case 9: return launch<144, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    case 10: return launch<160, LP>(q, k, v, out, B, S, H, D, L, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out (B, S, H, D) bf16; k, v (B, L, H, D) bf16; all contiguous and
// 16-byte aligned. D a multiple of 8 up to 160, 1 <= L <= 256, S >= 1.
// Returns cudaGetLastError().
extern "C" int cross_attention_bf16(const void* q, const void* k, const void* v, void* out, int B,
                                    int S, int H, int D, int L, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 8 || D > 160 || D % 8 || L < 1 || L > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L <= 80) return (int)launch_d<80>(q, k, v, out, B, S, H, D, L, scale, st);
  return (int)launch_d<256>(q, k, v, out, B, S, H, D, L, scale, st);
}
