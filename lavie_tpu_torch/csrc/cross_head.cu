// The VSR only-cross transformer block's head, the pass before the
// frame-axis temporal attention (which needs the frame axis and forces the
// boundary; the tail after it is csrc/transformer_tail.cu):
//   xp = bf16(x Wpi^T + bpi)
//   then for i = 1, 2, with x0 = xp:
//     q  = bf16(LN_i(x_{i-1}) Wq_i^T * scale)
//     o  = bf16(bf16(softmax(q k_i^T)) v_i)      (8 heads x 64, <= 80 text keys)
//     x_i = bf16(bf16(o Wo_i^T + bo_i) + x_{i-1})
//   out = x2
// with x (B, N, C), Wpi, Wq_i, Wo_i (C, C) bf16 in nn.Linear layout, bpi,
// bo_i and LN_i's gamma, beta fp32, k_i, v_i (B, L, C) the projected text
// states, one row per video. Products accumulate in fp32; xp, q, the
// probabilities, o and each x_i are rounded to bf16 where the TPU body
// rounds them; the LayerNorm rounds its elementwise steps one by one; the
// softmax divides by its sum; each residual is a bf16 add after the
// rounding.
//
// Replaces: lavie_tpu/kernels/cross_block.py, cross_attention_head
// (_head_3d, body _head_kernel with _pair_attention).
//
// What bounds it on the H100: tensor-core operations. At the VSR L1 level
// (N = 327,680 tokens of C = 512) the five C x C products are 2*5*N*C^2 =
// 0.86 TFLOP and the two attentions 2 x 4*N*77*C = 0.10, ~0.97 ms at
// 989 TFLOP/s, against 2*N*C*2 bytes of activations in and out (0.67 GB,
// 0.20 ms at 3.35 TB/s).
//
// What the design does about it: nine launches back to back on the stream
// from one call, each a __global__ of this source so that a profile tells
// them apart, all on the pieces the tail and the text cross attention run
// on:
//   1. head_gemm_kernel<BN, EPI_BIAS>: xp, csrc/wgmma_gemm.cuh's staged
//      cooperative GEMM over K = C with the fp32 bias (a persistent,
//      warp-specialised wgmma GEMM fed by a TMA ring, whose tiles leave by
//      TMA from swizzled staging boxes: stored from registers, 16 bytes of
//      a row at a time, they took twice as long);
//   2. head_ln_kernel: LN_i(x_{i-1}) into xn, csrc/mma_tiles.cuh's
//      LayerNorm pass with its named roundings (the tail's too);
//   3. head_gemm_kernel<BN, EPI_SCALE>: q = bf16(acc * scale), no bias;
//   4. head_attn_kernel: o into xn's buffer (xn is dead by then),
//      csrc/cross_attn.cuh's wgmma body at scale 1
//      (persistent blocks, items heads fastest, a TMA ring of query tiles,
//      K and V loaded once per (video, head) and zero-filled by TMA past L,
//      the output stored by TMA); (B, N, C) is already (B, N, H, 64), so
//      neither K nor V is padded or transposed;
//   5. head_gemm_kernel<BN, EPI_BIAS_RES>: x_i, with the fp32 bias and the
//      residual x_{i-1}, loaded by TMA into the staging box under the
//      products, added after the first rounding (x1 overwrites xp in
//      place);
// and 2-5 again for the second layer. The weights (2.6 MB at C = 512) stay
// in L2 across each GEMM's tiles. What the design pays: xn, q and o round
// trips through device memory, about 20 passes of N x C bf16 in all (6.7 GB
// at L1, 2.0 ms at 3.35 TB/s), above the bound of its products.

#include "cross_attn.cuh"
#include "mma_tiles.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace wgemm;

constexpr int HEAD_D = 64;
using tiles::LN_ROWS;

// LN_i into xn: csrc/mma_tiles.cuh's LayerNorm pass, the tail's too.
template <int C>
__global__ void __launch_bounds__(tiles::THREADS) head_ln_kernel(const bf16* __restrict__ x,
                                                                const float* __restrict__ gamma,
                                                                const float* __restrict__ beta,
                                                                bf16* __restrict__ out, int N,
                                                                float eps) {
  tiles::layer_norm_pass<C>(x, gamma, beta, out, nullptr, N, eps);
}

// The head's GEMMs over K = C, wgmma_gemm.cuh's staged cooperative GEMM:
// EPI_BIAS (xp), EPI_SCALE (q), EPI_BIAS_RES (x1, x2), at BN = 128 or 256.
template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1) head_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_out, const __grid_constant__ CUtensorMap tm_res,
    const GemmArgs a) {
  coop_staged_gemm<BN, EPI>(&tm_a, &tm_w, &tm_out, &tm_res, a);
}

__global__ void __launch_bounds__(xattn::THREADS, 1) head_attn_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
    const xattn::CrossArgs a) {
  xattn::cross_body<HEAD_D>(&tm_q, &tm_k, &tm_v, &tm_o, a);
}

template <int EPI>
cudaError_t launch_epi(const CUtensorMap& ma, const CUtensorMap& mw, const CUtensorMap& mo,
                       const CUtensorMap& mr, const GemmArgs& a, int bn, int grid, cudaStream_t st) {
  const int smem = ring_smem(a.stages, (BM + bn) * ROW_BYTES, staged_extra(bn));
  switch (bn) {
    case 128: return launch_gemm(head_gemm_kernel<128, EPI>, smem, a, grid, st, ma, mw, mo, mr);
    case 256: return launch_gemm(head_gemm_kernel<256, EPI>, smem, a, grid, st, ma, mw, mo, mr);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_ln(const bf16* x, const void* g, const void* b, bf16* out, int rows, int C,
                      float eps, cudaStream_t st) {
  const int grid = (rows + LN_ROWS - 1) / LN_ROWS;
  const float *gf = static_cast<const float*>(g), *bf = static_cast<const float*>(b);
  switch (C) {
    case 128: head_ln_kernel<128><<<grid, tiles::THREADS, 0, st>>>(x, gf, bf, out, rows, eps); break;
    case 256: head_ln_kernel<256><<<grid, tiles::THREADS, 0, st>>>(x, gf, bf, out, rows, eps); break;
    case 512: head_ln_kernel<512><<<grid, tiles::THREADS, 0, st>>>(x, gf, bf, out, rows, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

struct Layer {
  const void *g, *b, *wq, *wo, *bo, *k, *v;
};

}  // namespace

// x, out (B, N, C) bf16 with N % 64 == 0; wpi, wq*, wo* (C, C) bf16; bpi,
// g*, b*, bo* (C) fp32; k*, v* (B, L, C) bf16, L <= 80 text keys; C in
// {128, 256, 512}, head dim 64. xp, xn, q (B, N, C): bf16 scratch; xn also
// takes the attention's output o (dead once the q GEMM read it, o is read
// by the out GEMM before the next LayerNorm writes xn). All contiguous and
// 16-byte aligned. The launch plan
// (kernels/cross_block.py::head_launch_plan): the GEMMs' tile width gemm_bn
// (128 or 256, dividing C) and ring stages, at most `grid` persistent
// blocks each; the attention's ring of attn_stages query tiles, attn_grid
// persistent blocks and attn_smem dynamic shared bytes. Nine launches on
// the stream; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// shape or plan the kernels cannot take.
extern "C" int cross_attention_head_bf16(
    const void* x, const void* wpi, const void* bpi, const void* g1, const void* b1,
    const void* wq1, const void* wo1, const void* bo1, const void* k1, const void* v1,
    const void* g2, const void* b2, const void* wq2, const void* wo2, const void* bo2,
    const void* k2, const void* v2, void* out, void* xp, void* xn, void* q, int B, int N,
    int C, int L, int gemm_bn, int gemm_stages, int grid, int attn_stages, int attn_grid,
    int attn_smem, float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows_ll = (long long)B * N;
  if (B < 1 || B > 65535 || N < xattn::WG_ROWS || N % xattn::WG_ROWS || L < 1 ||
      L > xattn::KEYS || (C != 128 && C != 256 && C != 512) ||
      (gemm_bn != 128 && gemm_bn != 256) || C % gemm_bn || gemm_stages < 2 ||
      gemm_stages > MAX_STAGES || grid < 1 || rows_ll > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rows = (int)rows_ll, H = C / HEAD_D;
  const long long items = (long long)B * H * (N / xattn::WG_ROWS);
  if (attn_stages < 2 * xattn::CW || attn_stages > xattn::MAX_STAGES || attn_grid < 1 ||
      attn_grid > items || items > 0x7fffffffLL ||
      attn_smem < xattn::smem_need(1, xattn::KEYS, attn_stages, xattn::WG_ROWS) ||
      attn_smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  bf16 *xpb = static_cast<bf16*>(xp), *xnb = static_cast<bf16*>(xn), *qb = static_cast<bf16*>(q);
  // the GEMMs' A operands (boxes of BM rows), and their outputs and
  // residual (boxes of a warpgroup's STAGED_ROWS)
  CUtensorMap m_x, m_xn, m_wpi, s_xp, s_q, s_out;
  if (!make_map_2d(&m_x, x, C, rows, BM) || !make_map_2d(&m_xn, xnb, C, rows, BM) ||
      !make_map_2d(&m_wpi, wpi, C, C, gemm_bn) ||
      !make_map_2d(&s_xp, xpb, C, rows, STAGED_ROWS) || !make_map_2d(&s_q, qb, C, rows, STAGED_ROWS) ||
      !make_map_2d(&s_out, out, C, rows, STAGED_ROWS))
    return (int)cudaErrorNotSupported;
  const int k_blocks = C / SLAB, col_tiles = C / gemm_bn;
  // 1. xp = bf16(x Wpi^T + bpi)
  const GemmArgs proj{bpi, xpb, rows, C, k_blocks, col_tiles, gemm_stages, 0, nullptr, 0.f};
  cudaError_t err = launch_epi<EPI_BIAS>(m_x, m_wpi, s_xp, s_xp, proj, gemm_bn, grid, st);
  if (err != cudaSuccess) return (int)err;
  const Layer layers[2] = {{g1, b1, wq1, wo1, bo1, k1, v1}, {g2, b2, wq2, wo2, bo2, k2, v2}};
  for (int i = 0; i < 2; ++i) {
    const Layer& p = layers[i];
    // 2. xn = LN_i(x_{i-1}), x_{i-1} in xp
    err = launch_ln(xpb, p.g, p.b, xnb, rows, C, eps, st);
    if (err != cudaSuccess) return (int)err;
    // 3. q = bf16(xn Wq^T * scale)
    CUtensorMap m_wq, m_wo;
    if (!make_map_2d(&m_wq, p.wq, C, C, gemm_bn) || !make_map_2d(&m_wo, p.wo, C, C, gemm_bn))
      return (int)cudaErrorNotSupported;
    const GemmArgs qa{nullptr, qb, rows, C, k_blocks, col_tiles, gemm_stages, 0, nullptr, scale};
    err = launch_epi<EPI_SCALE>(m_xn, m_wq, s_q, s_q, qa, gemm_bn, grid, st);
    if (err != cudaSuccess) return (int)err;
    // 4. o = attention of q over the layer's text keys, at scale 1 (q holds
    // it), into xn
    const xattn::CrossArgs ca{xnb, N, H, HEAD_D, L, xattn::KEYS, xattn::WG_ROWS, attn_stages,
                              (int)items, 1.4426950408889634f};
    CUtensorMap mq, mk, mv, mo;
    if (!xattn::make_maps(&mq, &mk, &mv, &mo, qb, p.k, p.v, ca, B)) return (int)cudaErrorNotSupported;
    err = cudaFuncSetAttribute(head_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               attn_smem);
    if (err != cudaSuccess) return (int)err;
    head_attn_kernel<<<attn_grid, xattn::THREADS, attn_smem, st>>>(mq, mk, mv, mo, ca);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // 5. x_i = bf16(bf16(o Wo^T + bo) + x_{i-1}): x1 over xp in place (each
    // tile's residual is read before its output is stored, by the block
    // that owns it), x2 into out
    bf16* dst = i == 0 ? xpb : static_cast<bf16*>(out);
    const GemmArgs oa{p.bo, dst, rows, C, k_blocks, col_tiles, gemm_stages, 0, xpb, 0.f};
    err = launch_epi<EPI_BIAS_RES>(m_xn, m_wo, i == 0 ? s_xp : s_out, s_xp, oa, gemm_bn, grid, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
