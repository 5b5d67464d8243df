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
// out_proj_residual: each block owns 64 tokens and reads them once into a
// (64, E) bf16 tile in shared memory (165 KB at E = 1280); the product
// runs in passes of 128 or 256 output columns whose weights stream through
// a double-buffered cp.async ring (mma.sync m16n8k16, fp32 accumulators in
// registers), each pass rounded and stored straight from the registers,
// with its epilogue. The weights are read once per block from L2, the cost
// of this simple design (the staged GEMM with EPI_BIAS_RES would share
// them).

#include "mma_tiles.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = wgemm;

using namespace tiles;
constexpr int ROWS = 64;

template <int K>
struct Proj {
  static constexpr int LD = K + 8;
  static constexpr int NC = K % 256 ? 128 : 256;  // output columns per product pass
  static constexpr size_t SMEM = (size_t)ROWS * LD * 2 + 2 * (size_t)NC * WLD * 2;
};

// The (ROWS, K) tile of tokens r0.. of a (N, K) tensor, zero past N.
template <int K>
__device__ __forceinline__ void load_tile(bf16* T, const bf16* src, int r0, int N) {
  constexpr int LD = Proj<K>::LD;
  for (int idx = threadIdx.x; idx < ROWS * K / 8; idx += THREADS) {
    const int r = idx / (K / 8), c8 = idx % (K / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < N) v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * K + c8 * 8);
    *reinterpret_cast<uint4*>(T + r * LD + c8 * 8) = v;
  }
  __syncthreads();
}

// xn = LayerNorm(x): csrc/mma_tiles.cuh's LayerNorm pass, the head's and
// the tail's too.
template <int C>
__global__ void __launch_bounds__(THREADS) ln_qkv_ln_kernel(const bf16* __restrict__ x,
                                                           const float* __restrict__ gamma,
                                                           const float* __restrict__ beta,
                                                           bf16* __restrict__ xn, int N, float eps) {
  layer_norm_pass<C>(x, gamma, beta, xn, nullptr, N, eps);
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

template <int E>
__global__ void __launch_bounds__(THREADS, 1) out_proj_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ r, const bf16* __restrict__ wo,
    const float* __restrict__ bo, bf16* __restrict__ y, int N, int O) {
  constexpr int LD = Proj<E>::LD, NC = Proj<E>::NC;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* T = reinterpret_cast<bf16*>(smem);
  bf16* ring = T + ROWS * LD;
  const int r0 = blockIdx.x * ROWS;
  load_tile<E>(T, o, r0, N);
  for (int n0 = 0; n0 < O; n0 += NC) {
    float acc[ROWS / 16][NC / 64][4];
    zero<ROWS, NC>(acc);
    gemm<ROWS, NC, E>(acc, T, LD, [&](int c) { return wo + (size_t)min(n0 + c, O - 1) * E; },
                      ring);
    each_pair<ROWS, NC>(acc, [&](int rr, int c, float v0, float v1) {
      if (n0 + c >= O || r0 + rr >= N) return;
      const size_t off = (size_t)(r0 + rr) * O + n0 + c;
      *reinterpret_cast<__nv_bfloat162*>(y + off) =
          __hadd2(__floats2bfloat162_rn(v0 + bo[n0 + c], v1 + bo[n0 + c + 1]),
                  *reinterpret_cast<const __nv_bfloat162*>(r + off));
    });
  }
}

cudaError_t launch_ln(const void* x, const void* g, const void* b, bf16* xn, int N, int C,
                      float eps, cudaStream_t st) {
  const int grid = (N + LN_ROWS - 1) / LN_ROWS;
  const bf16* xb = static_cast<const bf16*>(x);
  const float *gf = static_cast<const float*>(g), *bf = static_cast<const float*>(b);
  switch (C) {
    case 320: ln_qkv_ln_kernel<320><<<grid, THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    case 512: ln_qkv_ln_kernel<512><<<grid, THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    case 640: ln_qkv_ln_kernel<640><<<grid, THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    case 1024: ln_qkv_ln_kernel<1024><<<grid, THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    case 1280: ln_qkv_ln_kernel<1280><<<grid, THREADS, 0, st>>>(xb, gf, bf, xn, N, eps); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_qkv_gemm(const QkvMaps& m, const wg::GemmArgs& a, int grid, cudaStream_t st) {
  const int smem = wg::ring_smem(a.stages, (wg::BM + BN) * wg::ROW_BYTES, wg::staged_extra(BN));
  return wg::launch_gemm(ln_qkv_gemm_kernel<BN>, smem, a, grid, st, m);
}

template <int E>
cudaError_t launch_out_proj(const void* o, const void* r, const void* wo, const void* bo, void* y,
                            int N, int O, cudaStream_t st) {
  cudaError_t err = prepare(out_proj_kernel<E>, Proj<E>::SMEM);
  if (err != cudaSuccess) return err;
  out_proj_kernel<E><<<(N + ROWS - 1) / ROWS, THREADS, Proj<E>::SMEM, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(r), static_cast<const bf16*>(wo),
      static_cast<const float*>(bo), static_cast<bf16*>(y), N, O);
  return cudaGetLastError();
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
  const long long tiles = (long long)(N + wg::BM - 1) / wg::BM * 3 * (E / (bn > 0 ? bn : 1));
  if (N < 1 || (bn != 128 && bn != 160 && bn != 256) || E < bn || E % bn || stages < 2 ||
      stages > wg::MAX_STAGES || grid < 1 || tiles > 0x7fffffffLL ||
      wg::ring_smem(stages, (wg::BM + bn) * wg::ROW_BYTES, wg::staged_extra(bn)) > wg::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* xnb = static_cast<bf16*>(xn);
  cudaError_t err = launch_ln(x, g, b, xnb, N, C, eps, st);
  if (err != cudaSuccess) return (int)err;
  QkvMaps m;
  const void* w[3] = {wq, wk, wv};
  void* o[3] = {q, k, v};
  if (!wg::make_map_2d(&m.a, xnb, C, N, wg::BM)) return (int)cudaErrorNotSupported;
  for (int i = 0; i < 3; ++i) {
    const bool ok = wg::make_map_2d(&m.w[i], w[i], C, E, bn) &&
                    (bn % wg::SLAB == 0 ? wg::make_map_2d(&m.out[i], o[i], E, N, wg::STAGED_ROWS)
                                        : wg::make_map_2d_dense(&m.out[i], o[i], E, N, bn,
                                                                wg::STAGED_ROWS));
    if (!ok) return (int)cudaErrorNotSupported;
  }
  const wg::GemmArgs a{nullptr, nullptr, N, E, C / wg::SLAB, 3 * (E / bn), stages, 0, nullptr, 0.f};
  switch (bn) {
    case 128: return (int)launch_qkv_gemm<128>(m, a, grid, st);
    case 160: return (int)launch_qkv_gemm<160>(m, a, grid, st);
    default: return (int)launch_qkv_gemm<256>(m, a, grid, st);
  }
}

// o (N, E) bf16; r, y (N, O) bf16; wo (O, E) bf16; bo (O) fp32. E in {320,
// 512, 640, 1024, 1280}, O even and >= 2, N >= 1. Returns cudaGetLastError().
extern "C" int out_proj_residual_bf16(const void* o, const void* r, const void* wo, const void* bo,
                                      void* y, int N, int E, int O, void* stream) {
  if (N < 1 || O < 2 || O % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 320: return (int)launch_out_proj<320>(o, r, wo, bo, y, N, O, st);
    case 512: return (int)launch_out_proj<512>(o, r, wo, bo, y, N, O, st);
    case 640: return (int)launch_out_proj<640>(o, r, wo, bo, y, N, O, st);
    case 1024: return (int)launch_out_proj<1024>(o, r, wo, bo, y, N, O, st);
    case 1280: return (int)launch_out_proj<1280>(o, r, wo, bo, y, N, O, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
