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
// What the design does about it: each block owns 64 tokens and reads them
// once into a (64, C) bf16 tile in shared memory (165 KB at C = 1280);
// ln_qkv normalises it in place, then the three projections run as one
// product of 3E output columns in passes of 128 or 256, whose weights
// stream through a double-buffered cp.async ring (mma.sync m16n8k16, fp32
// accumulators in registers; a pass that straddles two of the weights picks
// each column's row), and each pass is rounded and stored straight from the
// registers. out_proj_residual is the same product over the output tile
// with its epilogue. The weights are read once per block from L2, the cost
// of this simple design (wgmma and TMA multicast across a cluster would
// share them).

#include "mma_tiles.cuh"

namespace {

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

template <int C>
__global__ void __launch_bounds__(THREADS, 1) ln_qkv_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
    const bf16* __restrict__ wq, const bf16* __restrict__ wk, const bf16* __restrict__ wv,
    bf16* __restrict__ q, bf16* __restrict__ k, bf16* __restrict__ v, int N, int E, float eps) {
  constexpr int LD = Proj<C>::LD, NC = Proj<C>::NC;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* XN = reinterpret_cast<bf16*>(smem);
  bf16* ring = XN + ROWS * LD;
  const int r0 = blockIdx.x * ROWS, cols = 3 * E;
  load_tile<C>(XN, x, r0, N);
  layer_norm<ROWS, C>(XN, XN, LD, gamma, beta, eps);
  const bf16* const w[3] = {wq, wk, wv};
  bf16* const o[3] = {q, k, v};
  for (int n0 = 0; n0 < cols; n0 += NC) {
    float acc[ROWS / 16][NC / 64][4];
    zero<ROWS, NC>(acc);
    gemm<ROWS, NC, C>(acc, XN, LD, [&](int c) {
      const int j = min(n0 + c, cols - 1), which = j / E;
      return w[which] + (size_t)(j - which * E) * C;
    }, ring);
    each_pair<ROWS, NC>(acc, [&](int r, int c, float v0, float v1) {
      const int j = n0 + c, which = j / E;  // E even: a pair never straddles two outputs
      if (j >= cols || r0 + r >= N) return;
      *reinterpret_cast<__nv_bfloat162*>(o[which] + (size_t)(r0 + r) * E + j - which * E) =
          __floats2bfloat162_rn(v0, v1);
    });
  }
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

template <int C>
cudaError_t launch_ln_qkv(const void* x, const void* g, const void* b, const void* wq,
                          const void* wk, const void* wv, void* q, void* k, void* v, int N, int E,
                          float eps, cudaStream_t st) {
  cudaError_t err = prepare(ln_qkv_kernel<C>, Proj<C>::SMEM);
  if (err != cudaSuccess) return err;
  ln_qkv_kernel<C><<<(N + ROWS - 1) / ROWS, THREADS, Proj<C>::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const bf16*>(wq), static_cast<const bf16*>(wk), static_cast<const bf16*>(wv),
      static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v), N, E, eps);
  return cudaGetLastError();
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
// bf16. C in {320, 512, 640, 1024, 1280}, E even and >= 2, N >= 1.
// Returns cudaGetLastError().
extern "C" int ln_qkv_bf16(const void* x, const void* g, const void* b, const void* wq,
                           const void* wk, const void* wv, void* q, void* k, void* v, int N,
                           int C, int E, float eps, void* stream) {
  if (N < 1 || E < 2 || E % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 320: return (int)launch_ln_qkv<320>(x, g, b, wq, wk, wv, q, k, v, N, E, eps, st);
    case 512: return (int)launch_ln_qkv<512>(x, g, b, wq, wk, wv, q, k, v, N, E, eps, st);
    case 640: return (int)launch_ln_qkv<640>(x, g, b, wq, wk, wv, q, k, v, N, E, eps, st);
    case 1024: return (int)launch_ln_qkv<1024>(x, g, b, wq, wk, wv, q, k, v, N, E, eps, st);
    case 1280: return (int)launch_ln_qkv<1280>(x, g, b, wq, wk, wv, q, k, v, N, E, eps, st);
    default: return (int)cudaErrorInvalidValue;
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
