// GEGLU feed-forward of the transformer blocks:
//   act = bf16((x W0h^T + b0h) * gelu_erf(x W0g^T + b0g))
//   y   = bf16(act W2^T + b2)
// with x (N, C), W0 = [W0h; W0g] (2I, C), W2 (C, I) (nn.Linear weight
// layouts, bf16), fp32 accumulation on both products; act is rounded to
// bf16 before the second product, as the TPU body rounds it. I is 4C in a
// whole feed-forward and 4C/tp in a tensor-parallel shard (W0 then holds
// the shard's hidden rows and the same gate rows, W2 its columns), any
// multiple of 64; a shard passes no b2 and gets y = act W2^T in fp32, its
// partial product, which the caller sums over the ranks before adding b2
// and rounding once.
//
// Replaces: lavie_tpu/kernels/geglu.py, geglu (_geglu_2d, body
// _geglu_kernel).
//
// What bounds it on the H100: tensor-core operations. One base level is
// 6*N*C*I = 201 GFLOP (N = 81920, C = 320), 0.20 ms at 989 TFLOP/s dense
// bf16, against 2*N*C*2 bytes of activations (105 MB, 31 us at 3.35 TB/s).
//
// What the design does about it: two persistent, warp-specialised wgmma
// GEMMs, launched back to back on the stream by one call.
//   gate GEMM: act (N, I) from x (N, C): a tile is 128 rows by 64 columns
//     of the hidden and the same 64 columns of the gate; B is two TMA boxes
//     of W0 (hidden rows i0.., gate rows I + i0..) laid one after the other,
//     so one m64n128k16 wgmma gives a warpgroup the hidden and the gate of
//     the same columns in the same thread; the epilogue adds b0, applies the
//     gelu gate in registers (the TPU body's erf polynomial: one reciprocal
//     and one exponential) and stores bf16 act by TMA from a staging box.
//     Its K (= C, 5 slabs at C = 320) is short and its epilogue long, so the
//     two consumer warpgroups take turns (ping-pong): each owns whole
//     tiles, and one's epilogue runs under the other's products.
//   out GEMM: y (N, C) from act over K = I, output tiles of 128 rows by a
//     legal wgmma width dividing C (128, 160 or 256); the epilogue adds b2
//     and rounds once. At 128 and 160 the consumer warpgroups take turns as
//     in the gate GEMM; at 256 (one m64n256 accumulator a warpgroup) both
//     work on each tile, 64 rows each.
// Both (csrc/wgmma_gemm.cuh, shared with transformer_tail.cu): warpgroup 0
// is the producer, one thread keeping a ring of 4-6 stages of TMA loads in
// flight (the A tile's 64-column slab and the B slab, both
// K-major in 128-byte swizzled boxes) across tiles, and wgmma reads both
// operands from shared memory. Tiles walk the columns fastest, so the
// blocks running at one time share A row tiles and all of the weights (2.5
// to 39 MB) through the 50 MB L2.
// The act round trip (4*N*I bytes) is the design's cost: a row tile's 640 KB
// fp32 output at C = 1280 cannot stay in one SM's registers across the
// second product.

#include "wgmma_gemm.cuh"

namespace {

using namespace wgemm;

// F32: the out GEMM stores fp32 products without b2 (a tensor-parallel shard)
template <int BN, bool GATE, bool F32>
__global__ void __launch_bounds__(THREADS, 1) geglu_pingpong_kernel(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const __grid_constant__ CUtensorMap tm_act, const GemmArgs a) {
  pingpong_gemm<BN, GATE, bf16, false, F32>(&tm_a, &tm_b, &tm_act, a);
}

template <int BN, bool F32>
__global__ void __launch_bounds__(THREADS, 1) geglu_coop_kernel(
    const __grid_constant__ CUtensorMap tm_act, const __grid_constant__ CUtensorMap tm_w2,
    const GemmArgs a) {
  coop_gemm<BN, bf16, false, F32>(&tm_act, &tm_w2, a);
}

template <bool F32>
cudaError_t launch_out(const CUtensorMap& ma, const CUtensorMap& mb, const GemmArgs& a, int bn,
                       int grid, cudaStream_t st) {
  const int smem = ring_smem(a.stages, (BM + bn) * ROW_BYTES, 0);
  switch (bn) {
    case 128: return launch_gemm(geglu_pingpong_kernel<128, false, F32>, smem, a, grid, st, ma, mb, ma);
    case 160: return launch_gemm(geglu_pingpong_kernel<160, false, F32>, smem, a, grid, st, ma, mb, ma);
    case 256: return launch_gemm(geglu_coop_kernel<256, F32>, smem, a, grid, st, ma, mb);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (N, C), w0 (2I, C), b0 (2I), w2 (C, I), b2 (C), y (N, C): bf16,
// contiguous, 32-byte aligned, C and I multiples of 64; b2 null: y is fp32
// (N, C), the products without a bias. act: bf16 scratch of N x I. The
// launch plan (kernels/geglu.py::launch_plan):
// gate_stages and out_stages ring stages; the out GEMM's tile width out_bn
// (128, 160 or 256, dividing C); at most `grid` persistent blocks a GEMM.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan
// the kernels cannot take.
extern "C" int geglu_bf16(const void* x, const void* w0, const void* b0, const void* w2,
                          const void* b2, void* y, void* act, int N, int C, int I,
                          int gate_stages, int out_bn, int out_stages, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (I < 64 || I % 64 || N < 1 || C < 64 || C % 64 || grid < 1 || out_bn < 8 || C % out_bn ||
      gate_stages < 2 || gate_stages > MAX_STAGES || out_stages < 2 || out_stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  bf16* actb = static_cast<bf16*>(act);
  CUtensorMap m_x, m_w0, m_act, m_w2;
  if (!make_map_2d(&m_x, x, C, N, BM) || !make_map_2d(&m_w0, w0, C, 2 * I, GATE_COLS) ||
      !make_map_2d(&m_act, actb, I, N, BM) || !make_map_2d(&m_w2, w2, I, C, out_bn))
    return (int)cudaErrorNotSupported;
  const GemmArgs gate{static_cast<const bf16*>(b0), actb, N, I, C / SLAB, I / GATE_COLS,
                      gate_stages, I};
  cudaError_t err =
      launch_gemm(geglu_pingpong_kernel<2 * GATE_COLS, true, false>,
                  ring_smem(gate_stages, stage_bytes<2 * GATE_COLS>(), 2 * A_BYTES), gate, grid, st,
                  m_x, m_w0, m_act);
  if (err != cudaSuccess) return (int)err;
  const bool partial = b2 == nullptr;
  GemmArgs out{static_cast<const bf16*>(b2), static_cast<bf16*>(y), N, C, I / SLAB,
               C / out_bn, out_stages, I};
  if (partial) {
    out.out = nullptr;
    out.out_f32 = static_cast<float*>(y);
  }
  err = partial ? launch_out<true>(m_act, m_w2, out, out_bn, grid, st)
                : launch_out<false>(m_act, m_w2, out, out_bn, grid, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaSuccess;
}
