// The text cross-attention (attn2) of every non-only-cross transformer
// block, with its LayerNorm and residual, from one call (opt-in,
// LAVIE_ATTN2=fused):
//   xn = LN(x)
//   q  = bf16(xn Wq^T * scale)
//   o  = bf16(bf16(softmax(q k^T)) v)           (8 heads x 40/80/128/160, and 64)
//   y  = bf16(bf16(o Wo^T + bo) + x)
// with x, y (B, N, C), N = F*S tokens a video, Wq, Wo (C, C) bf16 in
// nn.Linear layout, bo and the LayerNorm's gamma, beta fp32, k, v (B, L, C)
// the projected text states, one row per video, L <= 80. Arithmetic as the
// TPU kernel: LayerNorm statistics in fp32 with the elementwise steps
// rounded to bf16 one by one, products accumulated in fp32, q scaled in
// fp32 then rounded, fp32 softmax whose probabilities are rounded to bf16
// before P.V, o rounded before Wo, the bias added in fp32 before the first
// rounding and the residual in bf16 after it.
//
// Replaces: lavie_tpu/kernels/cross_block.py
//   fused_ln_cross_attention (_single_3d, body _single_kernel) -> fused_ln_cross_attention_bf16
//
// What bounds it on the H100: tensor-core operations. At the base L0 level
// (81,920 tokens of C = 320): 4*N*C^2 + 4*N*77*C = 0.042 TFLOP, 0.042 ms at
// 989 TFLOP/s, against 0.031 ms for reading and writing x.
//
// What the design does about it: four launches back to back on the stream
// from one call, each a __global__ of this source so that a profile tells
// them apart from the VSR only-cross head's (csrc/cross_head.cu runs the
// same pieces for its two layers):
//   1. fused_ln_kernel<C>: xn = LN(x) into a scratch, csrc/mma_tiles.cuh's
//      LayerNorm pass with its named roundings (the head's and the tail's);
//   2. fused_gemm_kernel<BN, EPI_SCALE>: q = bf16(acc * scale), no bias,
//      csrc/wgmma_gemm.cuh's staged cooperative GEMM (persistent,
//      warp-specialised wgmma fed by a TMA ring of xn and weight slabs,
//      tiles stored by TMA from staging boxes: swizzled slabs at BN = 128 or
//      256, one dense 64 x 160 box at BN = 160);
//   3. fused_attn_kernel<DP>: o into xn's buffer (dead by then),
//      csrc/cross_attn.cuh's wgmma body at scale 1 (q holds the scale):
//      persistent blocks, items heads fastest, a TMA ring of query tiles, K
//      and V loaded once per (video, head) straight from the caller's
//      (B, L, C) tensors, read as (B, L, H, d), the rows past L and the
//      columns past d zero-filled by TMA (no padding or transpose on the
//      host), the output stored by TMA; DP is d rounded up to 16; the 4-D
//      maps over (d, H, N, B) end each video's ragged last query tile at N;
//   4. fused_gemm_kernel<BN, EPI_BIAS_RES>: y = bf16(bf16(o Wo^T + bo) + x),
//      x loaded by TMA into the staging box under the products.
// The GEMMs see the B*N rows flat, and TMA clips their loads and stores
// at the last row. The weights (3.3 MB at C = 1280) stay in L2 across each
// GEMM's tiles. What the design pays: the xn, q and o round trips through
// device memory, 6*B*N*C*2 bytes more than x in and out.

#include "cross_attn.cuh"
#include "mma_tiles.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace wgemm;

constexpr int HEADS = 8;
using tiles::LN_ROWS;

// LN(x) into xn: csrc/mma_tiles.cuh's LayerNorm pass, the head's and the
// tail's too.
template <int C>
__global__ void __launch_bounds__(tiles::THREADS) fused_ln_kernel(const bf16* __restrict__ x,
                                                                 const float* __restrict__ gamma,
                                                                 const float* __restrict__ beta,
                                                                 bf16* __restrict__ out, int N,
                                                                 float eps) {
  tiles::layer_norm_pass<C>(x, gamma, beta, out, nullptr, N, eps);
}

// The two GEMMs over K = C, wgmma_gemm.cuh's staged cooperative GEMM:
// EPI_SCALE (q), EPI_BIAS_RES (y), at BN = 128, 160 or 256.
template <int BN, int EPI>
__global__ void __launch_bounds__(THREADS, 1) fused_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_out, const __grid_constant__ CUtensorMap tm_res,
    const GemmArgs a) {
  coop_staged_gemm<BN, EPI>(&tm_a, &tm_w, &tm_out, &tm_res, a);
}

template <int DP>
__global__ void __launch_bounds__(xattn::THREADS, 1) fused_attn_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
    const xattn::CrossArgs a) {
  xattn::cross_body<DP>(&tm_q, &tm_k, &tm_v, &tm_o, a);
}

cudaError_t launch_ln(const void* x, const void* g, const void* b, bf16* out, int rows, int C,
                      float eps, cudaStream_t st) {
  const int grid = (rows + LN_ROWS - 1) / LN_ROWS;
  const bf16* xb = static_cast<const bf16*>(x);
  const float *gf = static_cast<const float*>(g), *bf = static_cast<const float*>(b);
  switch (C) {
#define LN_CASE(W) \
  case W: fused_ln_kernel<W><<<grid, tiles::THREADS, 0, st>>>(xb, gf, bf, out, rows, eps); break;
    LN_CASE(320) LN_CASE(512) LN_CASE(640) LN_CASE(1024) LN_CASE(1280)
#undef LN_CASE
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_epi(const CUtensorMap& ma, const CUtensorMap& mw, const CUtensorMap& mo,
                       const CUtensorMap& mr, const GemmArgs& a, int bn, int grid, cudaStream_t st) {
  const int smem = ring_smem(a.stages, (BM + bn) * ROW_BYTES, staged_extra(bn));
  switch (bn) {
    case 128: return launch_gemm(fused_gemm_kernel<128, EPI>, smem, a, grid, st, ma, mw, mo, mr);
    case 160: return launch_gemm(fused_gemm_kernel<160, EPI>, smem, a, grid, st, ma, mw, mo, mr);
    case 256: return launch_gemm(fused_gemm_kernel<256, EPI>, smem, a, grid, st, ma, mw, mo, mr);
    default: return cudaErrorInvalidValue;
  }
}

template <int DP>
cudaError_t launch_attn(const CUtensorMap (&m)[4], const xattn::CrossArgs& a, int grid, int smem,
                        cudaStream_t st) {
  if (smem < xattn::smem_need(xattn::Cfg<DP>::SLABS, xattn::KEYS, a.stages, xattn::WG_ROWS))
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fused_attn_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_attn_kernel<DP><<<grid, xattn::THREADS, smem, st>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

}  // namespace

// x, out (B, N, C) bf16, any N >= 1; wq, wo (C, C) bf16; g, b, bo (C) fp32;
// k, v (B, L, C) bf16, 1 <= L <= 80 text keys; (C, D) in {(320, 40),
// (640, 80), (1024, 128), (1280, 160), (512, 64)}, 8 heads of D. xn, q
// (B, N, C): bf16 scratch; xn also takes the attention's output o (dead
// once the q GEMM read it). All contiguous and 16-byte aligned. The launch
// plan (kernels/cross_block.py::fused_launch_plan): the GEMMs' tile width
// gemm_bn (128, 160 or 256, dividing C) and ring stages, at most `grid`
// persistent blocks each; the attention's ring of attn_stages query tiles,
// attn_grid persistent blocks and attn_smem dynamic shared bytes. Four
// launches on the stream; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan the kernels cannot take.
extern "C" int fused_ln_cross_attention_bf16(
    const void* x, const void* g, const void* b, const void* wq, const void* wo, const void* bo,
    const void* k, const void* v, void* out, void* xn, void* q, int B, int N, int C, int D, int L,
    int gemm_bn, int gemm_stages, int grid, int attn_stages, int attn_grid, int attn_smem,
    float scale, float eps, void* stream) {
  const long long rows_ll = (long long)B * N;
  const bool shape_ok = (C == 320 && D == 40) || (C == 640 && D == 80) || (C == 1024 && D == 128) ||
                        (C == 1280 && D == 160) || (C == 512 && D == 64);
  if (!shape_ok || B < 1 || B > 65535 || N < 1 || L < 1 || L > xattn::KEYS ||
      rows_ll > 0x7fffffffLL || !staged_plan_ok((int)rows_ll, C, 1, gemm_bn, gemm_stages, grid))
    return (int)cudaErrorInvalidValue;
  const int rows = (int)rows_ll;
  const long long items = (long long)B * HEADS * ((N + xattn::WG_ROWS - 1) / xattn::WG_ROWS);
  if (attn_stages < 2 * xattn::CW || attn_stages > xattn::MAX_STAGES || attn_grid < 1 ||
      attn_grid > items || items > 0x7fffffffLL || attn_smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16 *xnb = static_cast<bf16*>(xn), *qb = static_cast<bf16*>(q);
  // the GEMMs' A operand (boxes of BM rows), weights (boxes of gemm_bn
  // rows), and their outputs and residual (staging boxes)
  CUtensorMap m_xn, m_wq, m_wo, s_q, s_out, s_x;
  if (!make_map_2d(&m_xn, xnb, C, rows, BM) || !make_map_2d(&m_wq, wq, C, C, gemm_bn) ||
      !make_map_2d(&m_wo, wo, C, C, gemm_bn) || !make_staging_map(&s_q, qb, C, rows, gemm_bn) ||
      !make_staging_map(&s_out, out, C, rows, gemm_bn) || !make_staging_map(&s_x, x, C, rows, gemm_bn))
    return (int)cudaErrorNotSupported;
  // 1. xn = LN(x)
  cudaError_t err = launch_ln(x, g, b, xnb, rows, C, eps, st);
  if (err != cudaSuccess) return (int)err;
  // 2. q = bf16(xn Wq^T * scale)
  const int k_blocks = C / SLAB, col_tiles = C / gemm_bn;
  const GemmArgs qa{nullptr, qb, rows, C, k_blocks, col_tiles, gemm_stages, 0, nullptr, scale};
  err = launch_epi<EPI_SCALE>(m_xn, m_wq, s_q, s_q, qa, gemm_bn, grid, st);
  if (err != cudaSuccess) return (int)err;
  // 3. o = attention of q over the text keys, at scale 1 (q holds it), into xn
  const xattn::CrossArgs ca{xnb, N, HEADS, D, L, xattn::KEYS, xattn::WG_ROWS, attn_stages,
                            (int)items, 1.4426950408889634f};
  CUtensorMap ma[4];
  if (!xattn::make_maps(&ma[0], &ma[1], &ma[2], &ma[3], qb, k, v, ca, B))
    return (int)cudaErrorNotSupported;
  switch ((D + 15) / 16 * 16) {
    case 48: err = launch_attn<48>(ma, ca, attn_grid, attn_smem, st); break;
    case 64: err = launch_attn<64>(ma, ca, attn_grid, attn_smem, st); break;
    case 80: err = launch_attn<80>(ma, ca, attn_grid, attn_smem, st); break;
    case 128: err = launch_attn<128>(ma, ca, attn_grid, attn_smem, st); break;
    default: err = launch_attn<160>(ma, ca, attn_grid, attn_smem, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  // 4. y = bf16(bf16(o Wo^T + bo) + x)
  const GemmArgs oa{bo, static_cast<bf16*>(out), rows, C, k_blocks, col_tiles, gemm_stages, 0,
                    static_cast<const bf16*>(x), 0.f};
  return (int)launch_epi<EPI_BIAS_RES>(m_xn, m_wo, s_out, s_x, oa, gemm_bn, grid, st);
}
