// The two boundaries of the frame-axis temporal attention of every
// transformer block: the LayerNorm and the q/k/v projections before it,
// the out-projection and the residual after it.
//
// Replaces: lavie_tpu/kernels/temporal_proj.py
//   ln_qkv_cmajor     (_ln_qkv, body _ln_qkv_kernel)     -> ln_qkv_bf16
//   out_proj_residual (_out_proj, body _out_proj_kernel) -> out_proj_residual_bf16
//
// What they compute, on the N = B*F*S tokens of x (B, F, S, C) (the frame
// structure plays no part in either):
//   ln_qkv:   xn = LayerNorm(x) over C, fp32 statistics and the elementwise
//             steps rounded to bf16 one by one; q, k, v = bf16(xn Wq^T),
//             bf16(xn Wk^T), bf16(xn Wv^T), each accumulated in fp32 and
//             rounded once; emitted (B, F, S, E) each, the layout the
//             temporal attention kernel reads (the TPU kernel's channel-major
//             (E, B, F, S) output was a Mosaic layout).
//   out_proj_residual: y = bf16(bf16(o Wo^T + bo) + r): fp32 accumulation,
//             the bias added in fp32, one rounding, then the residual and a
//             second rounding; o (B, F, S, E), r and y (B, F, S, O).
// Weights bf16 in nn.Linear (out, in) layout; LayerNorm parameters and the
// bias fp32.
//
// What bounds them on the H100: device-memory bytes. At the base L0 level
// (81,920 tokens of C = E = 320) ln_qkv reads x once and writes q, k, v,
// (N*C + 3*N*E)*2 = 210 MB, 0.063 ms at 3.35 TB/s, against 6*N*C*E = 50
// GFLOP, 0.051 ms at 989 TFLOP/s; out_proj_residual moves 3*N*C*2 = 157 MB,
// 0.047 ms, against 17 GFLOP.
//
// What the design does about it. ln_qkv, two launches from one call on
// the pieces the VSR only-cross head runs on (csrc/cross_head.cu):
//   ln_qkv_ln_kernel<C>: csrc/mma_tiles.cuh's LayerNorm pass (the head's
//     and the tail's, with the plain version's roundings) writes xn (N, C)
//     bf16 into a scratch that the wrapper allocates (2*N*C*2 more bytes,
//     0.10 GB at base L0);
//   ln_qkv_gemm_kernel<BN>: csrc/wgmma_gemm.cuh's staged cooperative GEMM
//     (persistent, warp-specialised, a TMA ring of xn and weight slabs,
//     wgmma) over the 3E output columns of the three projections, tiles
//     walked (row tile, projection, column tile), each projection's weight
//     and output through its own TMA map (the weights are not concatenated),
//     y = bf16(acc) with no bias (EPI_NONE), each tile stored by TMA from a
//     staging box (swizzled slabs at BN = 128 or 256, one dense box at BN =
//     160, the width that divides E = 320 and 640). The weights stay in L2
//     across the tiles; every 128-row tile reads them once from there.
// out_proj_residual, one launch on the same GEMM:
//   out_proj_gemm_kernel<BN>: csrc/wgmma_gemm.cuh's staged cooperative GEMM
//     over the O output columns with EPI_BIAS_RES: A is o in 128-row boxes,
//     B is Wo in BN-row boxes, K = E walked in 64-column slabs; the
//     residual tile arrives by TMA into the staging box while the products
//     run, y = bf16(bf16(acc + bo) + r) is written back into the box and
//     leaves by TMA (one dense 64 x 160 box at BN = 160). The weights stay
//     in L2 across the tiles and are read once a 128-row tile.
// Both GEMMs take their tile width by the same rule (kernels/
// temporal_proj.py): the widest of 256, 160 and 128 dividing the output
// width whose tiles give every SM one, else the narrowest.

#include "mma_tiles.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = wgemm;

using tiles::LN_ROWS;
using wg::bf16;

// xn = LayerNorm(x): csrc/mma_tiles.cuh's LayerNorm pass, the head's and
// the tail's too.
template <int C>
__global__ void __launch_bounds__(tiles::THREADS) ln_qkv_ln_kernel(const bf16* __restrict__ x,
                                                           const float* __restrict__ gamma,
                                                           const float* __restrict__ beta,
                                                           bf16* __restrict__ xn, int N, float eps) {
  tiles::layer_norm_pass<C>(x, gamma, beta, xn, nullptr, N, eps);
}

// The three projections' maps: xn (boxes of 128 rows), Wq, Wk, Wv (boxes of
// BN rows) and q, k, v (boxes of 64 rows).
struct QkvMaps {
  CUtensorMap a, w[3], out[3];
};

// q, k, v = bf16(xn W^T) for W = Wq, Wk, Wv: the staged cooperative GEMM
// over 3 groups of E / BN column tiles, no bias.
template <int BN>
__global__ void __launch_bounds__(wg::THREADS, 1) ln_qkv_gemm_kernel(const __grid_constant__ QkvMaps m,
                                                                    const wg::GemmArgs a) {
  wg::coop_staged_gemm<BN, wg::EPI_NONE, 3>(&m.a, m.w, m.out, m.out, a);
}

// y = bf16(bf16(o Wo^T + bo) + r): the staged cooperative GEMM over O / BN
// column tiles, the residual loaded by TMA into the staging box.
template <int BN>
__global__ void __launch_bounds__(wg::THREADS, 1) out_proj_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_o, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_y, const __grid_constant__ CUtensorMap tm_r,
    const wg::GemmArgs a) {
  wg::coop_staged_gemm<BN, wg::EPI_BIAS_RES>(&tm_o, &tm_w, &tm_y, &tm_r, a);
}

cudaError_t launch_ln(const void* x, const void* g, const void* b, bf16* xn, int N, int C,
                      float eps, cudaStream_t st) {
  const int grid = (N + LN_ROWS - 1) / LN_ROWS;
  const bf16* xb = static_cast<const bf16*>(x);
  const float *gf = static_cast<const float*>(g), *bf = static_cast<const float*>(b);
  switch (C) {
    case 320: ln_qkv_ln_kernel<320><<<grid, tiles::THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    case 512: ln_qkv_ln_kernel<512><<<grid, tiles::THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    case 640: ln_qkv_ln_kernel<640><<<grid, tiles::THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    case 1024: ln_qkv_ln_kernel<1024><<<grid, tiles::THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    case 1280: ln_qkv_ln_kernel<1280><<<grid, tiles::THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_qkv_gemm(const QkvMaps& m, const wg::GemmArgs& a, int grid, cudaStream_t st) {
  const int smem = wg::ring_smem(a.stages, (wg::BM + BN) * wg::ROW_BYTES, wg::staged_extra(BN));
  return wg::launch_gemm(ln_qkv_gemm_kernel<BN>, smem, a, grid, st, m);
}

template <int BN>
cudaError_t launch_out_proj(const CUtensorMap (&m)[4], const wg::GemmArgs& a, int grid,
                            cudaStream_t st) {
  const int smem = wg::ring_smem(a.stages, (wg::BM + BN) * wg::ROW_BYTES, wg::staged_extra(BN));
  return wg::launch_gemm(out_proj_gemm_kernel<BN>, smem, a, grid, st, m[0], m[1], m[2], m[3]);
}

}  // namespace

// x (N, C) bf16; g, b (C) fp32; wq, wk, wv (E, C) bf16; q, k, v (N, E)
// bf16; xn (N, C) bf16 scratch for the normalised x. C in {320, 512, 640,
// 1024, 1280}, N >= 1. The launch plan (kernels/temporal_proj.py::
// ln_qkv_launch_plan): the GEMM's tile width bn (128, 160 or 256, dividing
// E), ring stages and at most `grid` persistent blocks. All contiguous and
// 16-byte aligned. Two launches; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan the kernels cannot take.
extern "C" int ln_qkv_bf16(const void* x, const void* g, const void* b, const void* wq,
                           const void* wk, const void* wv, void* q, void* k, void* v, void* xn,
                           int N, int C, int E, int bn, int stages, int grid, float eps,
                           void* stream) {
  if (!wg::staged_plan_ok(N, E, 3, bn, stages, grid)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* xnb = static_cast<bf16*>(xn);
  cudaError_t err = launch_ln(x, g, b, xnb, N, C, eps, st);
  if (err != cudaSuccess) return (int)err;
  QkvMaps m;
  const void* w[3] = {wq, wk, wv};
  void* o[3] = {q, k, v};
  if (!wg::make_map_2d(&m.a, xnb, C, N, wg::BM)) return (int)cudaErrorNotSupported;
  for (int i = 0; i < 3; ++i) {
    if (!wg::make_map_2d(&m.w[i], w[i], C, E, bn) || !wg::make_staging_map(&m.out[i], o[i], E, N, bn))
      return (int)cudaErrorNotSupported;
  }
  const wg::GemmArgs a{nullptr, nullptr, N, E, C / wg::SLAB, 3 * (E / bn), stages, 0, nullptr, 0.f};
  switch (bn) {
    case 128: return (int)launch_qkv_gemm<128>(m, a, grid, st);
    case 160: return (int)launch_qkv_gemm<160>(m, a, grid, st);
    default: return (int)launch_qkv_gemm<256>(m, a, grid, st);
  }
}

// o (N, E) bf16; r, y (N, O) bf16; wo (O, E) bf16; bo (O) fp32. E and O in
// {320, 512, 640, 1024, 1280}, N >= 1. The launch plan (kernels/
// temporal_proj.py::out_proj_launch_plan): the GEMM's tile width bn (128,
// 160 or 256, dividing O), ring stages and at most `grid` persistent
// blocks. All contiguous and 16-byte aligned. One launch; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan the
// kernel cannot take.
extern "C" int out_proj_residual_bf16(const void* o, const void* r, const void* wo, const void* bo,
                                      void* y, int N, int E, int O, int bn, int stages, int grid,
                                      void* stream) {
  if (E % wg::SLAB || E < wg::SLAB || !wg::staged_plan_ok(N, O, 1, bn, stages, grid))
    return (int)cudaErrorInvalidValue;
  CUtensorMap m[4];  // o, Wo, y, r
  if (!wg::make_map_2d(&m[0], o, E, N, wg::BM) || !wg::make_map_2d(&m[1], wo, E, O, bn) ||
      !wg::make_staging_map(&m[2], y, O, N, bn) || !wg::make_staging_map(&m[3], r, O, N, bn))
    return (int)cudaErrorNotSupported;
  const wg::GemmArgs a{bo, static_cast<bf16*>(y), N, O, E / wg::SLAB, O / bn, stages, 0,
                       static_cast<const bf16*>(r), 0.f};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 128: return (int)launch_out_proj<128>(m, a, grid, st);
    case 160: return (int)launch_out_proj<160>(m, a, grid, st);
    default: return (int)launch_out_proj<256>(m, a, grid, st);
  }
}
