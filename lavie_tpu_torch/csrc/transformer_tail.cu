// The VSR only-cross transformer block's tail, after the frame-axis
// temporal attention:
//   xn  = LN3(x)
//   act = bf16((xn W0h^T + b0h) * gelu_erf(xn W0g^T + b0g))
//   y   = bf16(bf16(act W2^T + b2) + x)
//   out = bf16(bf16(y Wpo^T + bpo) + r)
// with x, r (N, C), W0 = [W0h; W0g] (8C, C), W2 (C, 4C), Wpo (C, C) bf16 in
// nn.Linear layout, b0, b2, bpo and LN3's gamma, beta fp32. Products
// accumulate in fp32; act, y and out are rounded to bf16 where the TPU body
// rounds them, and each residual is a bf16 add after that rounding.
//
// Replaces: lavie_tpu/kernels/cross_block.py, transformer_tail (_tail_3d,
// body _tail_kernel).
//
// What bounds it on the H100: tensor-core operations. At the VSR L1 level
// (N = 327,680 tokens of C = 512) the products are 2*N*C*(2I + I + C) with
// I = 4C, 26*N*C^2 = 2.2 TFLOP, 2.26 ms at 989 TFLOP/s dense bf16, against
// 3*N*C*2 bytes of activations (1.0 GB, 0.30 ms at 3.35 TB/s).
//
// What the design does about it: a LayerNorm pass, then three persistent,
// warp-specialised wgmma GEMMs fed by TMA rings (csrc/wgmma_gemm.cuh, the
// pieces GEGLU runs on), launched back to back on the stream by one call:
//   1. tail_ln_kernel: LN3 into xn (bf16, N x C) with the LayerNorm of
//      csrc/mma_tiles.cuh (fp32 statistics, each elementwise step rounded
//      to bf16), 8 rows a block; layer_norm_bf16 runs it alone, with each
//      row's statistics, for the bit-exact test of its roundings;
//   2. tail_gemm_gate_kernel: GEGLU's gate GEMM on xn, act (N x 4C bf16)
//      stored by TMA from a swizzled staging box;
//   3. tail_gemm_out_kernel over K = I with W2: y = bf16(bf16(acc + b2) + x);
//   4. the same over K = C with Wpo: out = bf16(bf16(acc + bpo) + r).
// The running (rows x C) fp32 output cannot stay in a warpgroup's registers
// across the hidden width at a 64-row wgmma tile (128 KB at C = 512), so the
// act round trip through device memory (2 x 1.34 GB at L1, 0.8 ms at
// 3.35 TB/s) is the design's cost; the weights (6.8 MB at C = 512) stay in
// L2 across each GEMM's tiles instead of streaming once per 32 rows.

#include "mma_tiles.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace wgemm;

constexpr int LN_ROWS = tiles::THREADS / 32;  // one row a warp

// LN3 of 8 rows a block of 256 threads (one a warp) into xn, through
// shared memory; with stats, each row's fp32 (mean, inv) too, for the
// bit-exact test of its roundings (entry layer_norm_bf16).
template <int C>
__global__ void __launch_bounds__(tiles::THREADS) tail_ln_kernel(const bf16* __restrict__ x,
                                                                const float* __restrict__ gamma,
                                                                const float* __restrict__ beta,
                                                                bf16* __restrict__ out,
                                                                float2* __restrict__ stats, int N,
                                                                float eps) {
  constexpr int LD = C + 8;
  __shared__ __align__(16) unsigned char raw[LN_ROWS * LD * 2];
  __shared__ float2 st[LN_ROWS];
  bf16* T = reinterpret_cast<bf16*>(raw);
  const int r0 = blockIdx.x * LN_ROWS;
  for (int idx = threadIdx.x; idx < LN_ROWS * C / 8; idx += tiles::THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < N) v = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * C + c8 * 8);
    *reinterpret_cast<uint4*>(T + r * LD + c8 * 8) = v;
  }
  __syncthreads();
  tiles::layer_norm<LN_ROWS, C>(T, T, LD, gamma, beta, eps, stats != nullptr ? st : nullptr);
  __syncthreads();
  for (int idx = threadIdx.x; idx < LN_ROWS * C / 8; idx += tiles::THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    if (r0 + r < N)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * C + c8 * 8) =
          *reinterpret_cast<const uint4*>(T + r * LD + c8 * 8);
  }
  if (stats != nullptr && threadIdx.x < LN_ROWS && r0 + threadIdx.x < N)
    stats[r0 + threadIdx.x] = st[threadIdx.x];
}

__global__ void __launch_bounds__(THREADS, 1) tail_gemm_gate_kernel(
    const __grid_constant__ CUtensorMap tm_xn, const __grid_constant__ CUtensorMap tm_w0,
    const __grid_constant__ CUtensorMap tm_act, const GemmArgs a) {
  pingpong_gemm<2 * GATE_COLS, true, float, false>(&tm_xn, &tm_w0, &tm_act, a);
}

// the out GEMMs (+ bias + residual): ping-pong at 128, cooperative at 256
template <int BN>
__global__ void __launch_bounds__(THREADS, 1) tail_gemm_out_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_w,
    const GemmArgs a) {
  if constexpr (BN == 256)
    coop_gemm<BN, float, true>(&tm_a, &tm_w, a);
  else
    pingpong_gemm<BN, false, float, true>(&tm_a, &tm_w, &tm_a, a);
}

cudaError_t launch_out(const CUtensorMap& ma, const CUtensorMap& mw, const GemmArgs& a, int bn,
                       int grid, cudaStream_t st) {
  const int smem = ring_smem(a.stages, (BM + bn) * ROW_BYTES, 0);
  switch (bn) {
    case 128: return launch_gemm(tail_gemm_out_kernel<128>, smem, a, grid, st, ma, mw);
    case 256: return launch_gemm(tail_gemm_out_kernel<256>, smem, a, grid, st, ma, mw);
    default: return cudaErrorInvalidValue;
  }
}

template <int C>
cudaError_t launch_ln(const void* x, const void* g, const void* b, void* out, void* stats, int N,
                      float eps, cudaStream_t st) {
  tail_ln_kernel<C><<<(N + LN_ROWS - 1) / LN_ROWS, tiles::THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<bf16*>(out), static_cast<float2*>(stats), N, eps);
  return cudaGetLastError();
}

}  // namespace

// x, r, out (N, C) bf16; w0 (8C, C), w2 (C, 4C), wpo (C, C) bf16; g3, b3,
// b0 (8C), b2, bpo fp32; C in {128, 256, 512}; contiguous, 16-byte aligned.
// xn (N, C), act (N, 4C) and y (N, C): bf16 scratch. The launch plan
// (kernels/cross_block.py::tail_launch_plan): gate_stages ring stages of the
// gate GEMM; the out GEMMs' tile width out_bn (128 or 256, dividing C) and
// out_stages, proj_stages of the GEMMs over K = 4C and K = C; at most `grid`
// persistent blocks a GEMM. Four launches on the stream; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan the
// kernels cannot take.
extern "C" int transformer_tail_bf16(const void* x, const void* r, const void* g3, const void* b3,
                                     const void* w0, const void* b0, const void* w2,
                                     const void* b2, const void* wpo, const void* bpo, void* out,
                                     void* xn, void* act, void* y, int N, int C, int gate_stages,
                                     int out_bn, int out_stages, int proj_stages, int grid,
                                     float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int I = 4 * C;
  auto bad_stages = [](int s) { return s < 2 || s > MAX_STAGES; };
  if (N < 1 || grid < 1 || (out_bn != 128 && out_bn != 256) || C % out_bn ||
      bad_stages(gate_stages) || bad_stages(out_stages) || bad_stages(proj_stages))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (C) {
    case 128: err = launch_ln<128>(x, g3, b3, xn, nullptr, N, eps, st); break;
    case 256: err = launch_ln<256>(x, g3, b3, xn, nullptr, N, eps, st); break;
    case 512: err = launch_ln<512>(x, g3, b3, xn, nullptr, N, eps, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  bf16 *xnb = static_cast<bf16*>(xn), *actb = static_cast<bf16*>(act), *yb = static_cast<bf16*>(y);
  CUtensorMap m_xn, m_w0, m_act, m_w2, m_y, m_wpo;
  if (!make_map_2d(&m_xn, xnb, C, N, BM) || !make_map_2d(&m_w0, w0, C, 2 * I, GATE_COLS) ||
      !make_map_2d(&m_act, actb, I, N, BM) || !make_map_2d(&m_w2, w2, I, C, out_bn) ||
      !make_map_2d(&m_y, yb, C, N, BM) || !make_map_2d(&m_wpo, wpo, C, C, out_bn))
    return (int)cudaErrorNotSupported;
  const GemmArgs gate{b0, actb, N, I, C / SLAB, I / GATE_COLS, gate_stages, I, nullptr};
  err = launch_gemm(tail_gemm_gate_kernel,
                    ring_smem(gate_stages, stage_bytes<2 * GATE_COLS>(), 2 * A_BYTES), gate, grid,
                    st, m_xn, m_w0, m_act);
  if (err != cudaSuccess) return (int)err;
  const GemmArgs ff{b2, yb, N, C, I / SLAB, C / out_bn, out_stages, I,
                    static_cast<const bf16*>(x)};
  err = launch_out(m_act, m_w2, ff, out_bn, grid, st);
  if (err != cudaSuccess) return (int)err;
  const GemmArgs proj{bpo, static_cast<bf16*>(out), N, C, C / SLAB, C / out_bn, proj_stages, I,
                      static_cast<const bf16*>(r)};
  return (int)launch_out(m_y, m_wpo, proj, out_bn, grid, st);
}

// The LayerNorm pass alone: x, out (N, C) bf16; g, b (C) fp32; stats (N, 2)
// fp32 each row's (mean, inv). C in {128, 256, 320, 512, 640, 1024, 1280}
// (the widths of every kernel that runs the shared LayerNorm). Returns
// cudaGetLastError().
extern "C" int layer_norm_bf16(const void* x, const void* g, const void* b, void* out,
                               void* stats, int N, int C, float eps, void* stream) {
  if (N < 1 || stats == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch_ln<128>(x, g, b, out, stats, N, eps, st);
    case 256: return (int)launch_ln<256>(x, g, b, out, stats, N, eps, st);
    case 320: return (int)launch_ln<320>(x, g, b, out, stats, N, eps, st);
    case 512: return (int)launch_ln<512>(x, g, b, out, stats, N, eps, st);
    case 640: return (int)launch_ln<640>(x, g, b, out, stats, N, eps, st);
    case 1024: return (int)launch_ln<1024>(x, g, b, out, stats, N, eps, st);
    case 1280: return (int)launch_ln<1280>(x, g, b, out, stats, N, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
