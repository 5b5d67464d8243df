// The VSR only-cross transformer block as two fused passes around the
// frame-axis temporal attention (the temporal attention needs the frame
// axis and forces the boundary):
//   head: xp = x Wpi^T + bpi; x1 = xp + Attn(LN1(xp); k1, v1);
//         x2 = x1 + Attn(LN2(x1); k2, v2)           (8 heads x 64, 77 text keys)
//   tail: y = (GEGLU(LN3(x)) + x) Wpo^T + bpo + r   (hidden|gate, erf gelu)
// and, for the text cross-attention (attn2) of every other transformer
// block, the head's second half alone:
//   single: y = x + Attn(LN(x); k, v) Wo^T + bo     (8 heads x 40/80/128/160)
// Weights bf16 in nn.Linear (out, in) layout; biases and LayerNorm
// parameters fp32. Arithmetic as the TPU kernels: LayerNorm statistics in
// fp32 with the elementwise steps rounded to bf16 one by one (mul.rn and
// add.rn, so that no compiler fuses gamma's product and beta's sum into one
// fma), products accumulated in fp32, q scaled in fp32 then rounded, fp32
// softmax whose probabilities are rounded to bf16 before P.V, each residual
// added in bf16. layer_norm_bf16 runs the LayerNorm alone, for its test.
//
// Replaces: lavie_tpu/kernels/cross_block.py
//   cross_attention_head     (_head_3d, body _head_kernel)     -> cross_attention_head_bf16
//   transformer_tail         (_tail_3d, body _tail_kernel)     -> transformer_tail_bf16
//   fused_ln_cross_attention (_single_3d, body _single_kernel) -> fused_ln_cross_attention_bf16
//
// The single kernel at the base L0 level (81,920 tokens of C = 320): 4*N*C^2
// + 4*N*77*C = 0.042 TFLOP, 0.042 ms at 989 TFLOP/s, against 0.031 ms for
// reading and writing x. It is the head's design with two (ROWS, C) tiles
// (the normalised rows, then q, overwritten head by head with the attention
// output) and x re-read for the residual: 64 rows up to C = 640 and 32 rows
// above. Head dims 40 to 160; a head dim of 40 ends in half a k-step, whose
// upper q and k fragment registers are zeroed.
//
// What bounds them on the H100: tensor-core operations. At the VSR L1 level
// (327,680 tokens of C = 512) the head is 5 C x C products, 2*5*N*C^2 = 0.86
// TFLOP plus 2 x 4*N*77*C of attention (0.10), ~1.0 ms at 989 TFLOP/s; the
// tail is 2*N*C*(2I + I + C) with I = 4C = 2.2 TFLOP, ~2.3 ms. The
// activation bytes (2 reads and 1 write of N*C bf16, 1 GB) take ~0.3 ms.
//
// What the design does about it: every intermediate (the projections, the
// normalised rows, q, the scores and probabilities, the GEGLU hidden) stays
// on chip. A head block owns 64 tokens and keeps three (64, C) bf16 tiles
// in shared memory (the residual stream, the normalised/attention-output
// tile and q): 224 KB at C = 512, one block per SM. The four projections
// are (64, C) x (C, C) products on mma.sync m16n8k16 whose weights stream
// through a double-buffered cp.async ring in chunks of 16 input channels;
// each warp owns a band of output columns, in two passes of 256 so the fp32
// accumulators stay in registers. The attention is per (16 tokens, head):
// q fragments from shared memory, the padded (80, C) keys and the
// transposed (C, 80) values read as fragments straight from L2 (one row
// per video, shared by every token block of that video), all 80 scores of
// a row in registers, exact softmax, P.V on the tensor cores. A tail block
// owns 32 tokens: LN3 into shared memory, then for each 128-wide chunk of
// the 4C hidden width the hidden|gate product (fp32, to shared memory), the
// erf-gelu gate into a bf16 chunk, and its product with the matching
// columns of W2 accumulated into the (32, C) fp32 output in registers; then
// + b2 + x and proj_out + bpo + r. The weights are read once per block from
// L2, the cost this simple design pays (ROADMAP: wgmma, TMA multicast of
// the weight tiles across a cluster, larger token tiles).

#include "mma_tiles.cuh"

namespace {

using namespace tiles;
constexpr int HEAD_D = 64;
constexpr int KV = 80;        // text keys, zero-padded

// ----------------------------------------------------------------------------
// head
// ----------------------------------------------------------------------------

constexpr int HROWS = 64;

template <int C>
struct Head {
  static constexpr int LD = C + 8;
  static constexpr int NC = C < 256 ? C : 256;  // output columns per product pass
  static constexpr size_t SMEM = 3 * (size_t)HROWS * LD * 2 + 2 * (size_t)NC * WLD * 2;
};

struct AttnArgs {
  const float *gamma, *beta;
  const bf16 *wq, *wo;
  const float* bo;
  const bf16 *k, *vt;  // (B, KV, C), (B, C, KV)
};

// X <- X + to_out(softmax(LN(X) Wq^T * scale, k) v); uses XN and Q as scratch
template <int C>
__device__ void attention_layer(bf16* X, bf16* XN, bf16* Q, bf16* ring, const AttnArgs& p,
                                int brow, int L, float scale, float eps) {
  constexpr int LD = Head<C>::LD, NC = Head<C>::NC, H = C / HEAD_D;
  layer_norm<HROWS, C>(X, XN, LD, p.gamma, p.beta, eps);
  for (int n0 = 0; n0 < C; n0 += NC) {  // q = bf16(LN(X) Wq^T * scale)
    float acc[HROWS / 16][NC / 64][4];
    zero<HROWS, NC>(acc);
    gemm<HROWS, NC, C>(acc, XN, LD, [&](int c) { return p.wq + (size_t)(n0 + c) * C; }, ring);
    each_pair<HROWS, NC>(acc, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<__nv_bfloat162*>(Q + r * LD + n0 + c) =
          __floats2bfloat162_rn(v0 * scale, v1 * scale);
    });
  }
  __syncthreads();

  // one (16 tokens, head) item per warp at a time; the output goes to XN
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const bf16* kb = p.k + (size_t)brow * KV * C;
  const bf16* vb = p.vt + (size_t)brow * C * KV;
  for (int item = warp; item < (HROWS / 16) * H; item += THREADS / 32) {
    const int rg = item % (HROWS / 16), h = item / (HROWS / 16);
    uint32_t qa[HEAD_D / 16][4];
#pragma unroll
    for (int kk = 0; kk < HEAD_D / 16; ++kk)
      ldsm_x4(qa[kk], Q + (rg * 16 + (lane & 15)) * LD + h * HEAD_D + kk * 16 + (lane >> 4) * 8);
    float s[KV / 8][4];
#pragma unroll
    for (int nt = 0; nt < KV / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = kb + (size_t)(nt * 8 + g) * C + h * HEAD_D + tig * 2;
#pragma unroll
      for (int kk = 0; kk < HEAD_D / 16; ++kk)
        mma16816(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < KV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (nt * 8 + tig * 2 + (e & 1) >= L) s[nt][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    }
#pragma unroll
    for (int nt = 0; nt < KV / 8; ++nt)
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
    float o[HEAD_D / 8][4];
#pragma unroll
    for (int nt = 0; nt < HEAD_D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < KV / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * j][0] / sum[0], s[2 * j][1] / sum[0]),
          pack_bf16(s[2 * j][2] / sum[1], s[2 * j][3] / sum[1]),
          pack_bf16(s[2 * j + 1][0] / sum[0], s[2 * j + 1][1] / sum[0]),
          pack_bf16(s[2 * j + 1][2] / sum[1], s[2 * j + 1][3] / sum[1])};
#pragma unroll
      for (int nt = 0; nt < HEAD_D / 8; ++nt) {
        const bf16* vr = vb + (size_t)(h * HEAD_D + nt * 8 + g) * KV + j * 16 + tig * 2;
        mma16816(o[nt], pa, ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < HEAD_D / 8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(XN + (rg * 16 + g + hr * 8) * LD + h * HEAD_D +
                                           nt * 8 + tig * 2) =
            __floats2bfloat162_rn(o[nt][2 * hr], o[nt][2 * hr + 1]);
  }

  for (int n0 = 0; n0 < C; n0 += NC) {  // X = bf16(bf16(o Wo^T + bo) + X)
    float acc[HROWS / 16][NC / 64][4];
    zero<HROWS, NC>(acc);
    gemm<HROWS, NC, C>(acc, XN, LD, [&](int c) { return p.wo + (size_t)(n0 + c) * C; }, ring);
    each_pair<HROWS, NC>(acc, [&](int r, int c, float v0, float v1) {
      __nv_bfloat162* xr = reinterpret_cast<__nv_bfloat162*>(X + r * LD + n0 + c);
      *xr = __hadd2(__floats2bfloat162_rn(v0 + p.bo[n0 + c], v1 + p.bo[n0 + c + 1]), *xr);
    });
  }
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1) head_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wpi, const float* __restrict__ bpi,
    AttnArgs a1, AttnArgs a2, bf16* __restrict__ out, int N, int L, float scale, float eps) {
  constexpr int LD = Head<C>::LD, NC = Head<C>::NC;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* XN = X + HROWS * LD;
  bf16* Q = XN + HROWS * LD;
  bf16* ring = Q + HROWS * LD;
  const size_t row0 = (size_t)blockIdx.x * HROWS;  // token row of B*N; N % 64 == 0
  const int brow = (int)(row0 / N);

  for (int idx = threadIdx.x; idx < HROWS * C / 8; idx += THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    *reinterpret_cast<uint4*>(XN + r * LD + c8 * 8) =
        *reinterpret_cast<const uint4*>(x + (row0 + r) * C + c8 * 8);
  }
  for (int n0 = 0; n0 < C; n0 += NC) {  // xp = bf16(x Wpi^T + bpi)
    float acc[HROWS / 16][NC / 64][4];
    zero<HROWS, NC>(acc);
    gemm<HROWS, NC, C>(acc, XN, LD, [&](int c) { return wpi + (size_t)(n0 + c) * C; }, ring);
    each_pair<HROWS, NC>(acc, [&](int r, int c, float v0, float v1) {
      *reinterpret_cast<__nv_bfloat162*>(X + r * LD + n0 + c) =
          __floats2bfloat162_rn(v0 + bpi[n0 + c], v1 + bpi[n0 + c + 1]);
    });
  }
  __syncthreads();
  attention_layer<C>(X, XN, Q, ring, a1, brow, L, scale, eps);
  attention_layer<C>(X, XN, Q, ring, a2, brow, L, scale, eps);
  for (int idx = threadIdx.x; idx < HROWS * C / 8; idx += THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    *reinterpret_cast<uint4*>(out + (row0 + r) * C + c8 * 8) =
        *reinterpret_cast<const uint4*>(X + r * LD + c8 * 8);
  }
}

// ----------------------------------------------------------------------------
// tail
// ----------------------------------------------------------------------------

constexpr int TROWS = 32;
constexpr int BI = 128;  // hidden columns per chunk

template <int C>
struct Tail {
  static constexpr int LD = C + 8, HLD = 2 * BI + 4, ALD = BI + 8;
  static constexpr int RING_COLS = C > 2 * BI ? C : 2 * BI;
  static constexpr size_t SMEM = 2 * (size_t)TROWS * LD * 2 + (size_t)TROWS * HLD * 4 +
                                 (size_t)TROWS * ALD * 2 + 2 * (size_t)RING_COLS * WLD * 2;
};

template <int C>
__global__ void __launch_bounds__(THREADS, 1) tail_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ res, const float* __restrict__ g3,
    const float* __restrict__ b3, const bf16* __restrict__ w0, const float* __restrict__ b0,
    const bf16* __restrict__ w2, const float* __restrict__ b2, const bf16* __restrict__ wpo,
    const float* __restrict__ bpo, bf16* __restrict__ out, int N, float eps) {
  constexpr int LD = Tail<C>::LD, HLD = Tail<C>::HLD, ALD = Tail<C>::ALD, I = 4 * C;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* XN = X + TROWS * LD;
  float* HG = reinterpret_cast<float*>(XN + TROWS * LD);
  bf16* ACT = reinterpret_cast<bf16*>(HG + TROWS * HLD);
  bf16* ring = ACT + TROWS * ALD;
  const int row0 = blockIdx.x * TROWS;

  for (int idx = threadIdx.x; idx < TROWS * C / 8; idx += THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < N) v = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * C + c8 * 8);
    *reinterpret_cast<uint4*>(X + r * LD + c8 * 8) = v;
  }
  __syncthreads();
  layer_norm<TROWS, C>(X, XN, LD, g3, b3, eps);

  float oacc[TROWS / 16][C / 64][4];
  zero<TROWS, C>(oacc);
  for (int i0 = 0; i0 < I; i0 += BI) {
    {  // hidden | gate chunk (fp32, + b0) into HG
      auto row = [&](int c) { return c < BI ? i0 + c : I + i0 + c - BI; };
      float hacc[TROWS / 16][2 * BI / 64][4];
      zero<TROWS, 2 * BI>(hacc);
      gemm<TROWS, 2 * BI, C>(hacc, XN, LD, [&](int c) { return w0 + (size_t)row(c) * C; }, ring);
      each_pair<TROWS, 2 * BI>(hacc, [&](int r, int c, float v0, float v1) {
        HG[r * HLD + c] = v0 + b0[row(c)];
        HG[r * HLD + c + 1] = v1 + b0[row(c + 1)];
      });
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < TROWS * BI; idx += THREADS) {
      const int r = idx / BI, c = idx % BI;
      const float gt = HG[r * HLD + BI + c];
      ACT[r * ALD + c] =
          __float2bfloat16(HG[r * HLD + c] * (0.5f * gt * (1.f + erff(gt * 0.70710678118654752f))));
    }
    gemm<TROWS, C, BI>(oacc, ACT, ALD, [&](int c) { return w2 + (size_t)c * I + i0; }, ring);
  }
  // y = bf16(bf16(acc + b2) + x) into XN (free once the chunks are done)
  each_pair<TROWS, C>(oacc, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<__nv_bfloat162*>(XN + r * LD + c) =
        __hadd2(__floats2bfloat162_rn(v0 + b2[c], v1 + b2[c + 1]),
                *reinterpret_cast<const __nv_bfloat162*>(X + r * LD + c));
  });
  float pacc[TROWS / 16][C / 64][4];
  zero<TROWS, C>(pacc);
  gemm<TROWS, C, C>(pacc, XN, LD, [&](int c) { return wpo + (size_t)c * C; }, ring);
  each_pair<TROWS, C>(pacc, [&](int r, int c, float v0, float v1) {
    if (row0 + r >= N) return;
    const size_t off = (size_t)(row0 + r) * C + c;
    *reinterpret_cast<__nv_bfloat162*>(out + off) =
        __hadd2(__floats2bfloat162_rn(v0 + bpo[c], v1 + bpo[c + 1]),
                *reinterpret_cast<const __nv_bfloat162*>(res + off));
  });
}

// ----------------------------------------------------------------------------
// single: x + to_out(Attn(LN(x); k, v)) for the attn2 of every other block
// ----------------------------------------------------------------------------

// C in {320, 640, 1024, 1280} with head dim D = C / 8 (and 512 / 64). Two
// (ROWS, C) bf16 tiles: the normalised rows, then q, which the attention
// overwrites with its output head by head. 64 rows up to C = 640 and 32
// above keep both tiles and the ring within 227 KB (189 KB at C = 1280).
template <int C>
struct Single {
  static constexpr int ROWS = C > 640 ? 32 : 64;
  static constexpr int LD = C + 8;
  static constexpr int NC = C % 256 ? 128 : 256;  // output columns per product pass
  static constexpr size_t SMEM = 2 * (size_t)ROWS * LD * 2 + 2 * (size_t)NC * WLD * 2;
};

template <int C, int D>
__global__ void __launch_bounds__(THREADS, 1) single_kernel(const bf16* __restrict__ x,
                                                           AttnArgs p, bf16* __restrict__ out,
                                                           int N, int L, float scale, float eps) {
  static_assert(D % 8 == 0 && C % D == 0, "head dim a multiple of 8");
  constexpr int ROWS = Single<C>::ROWS, LD = Single<C>::LD, NC = Single<C>::NC, H = C / D;
  constexpr int KSTEPS = (D + 15) / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* XN = reinterpret_cast<bf16*>(smem);
  bf16* Q = XN + ROWS * LD;
  bf16* ring = Q + ROWS * LD;
  const int brow = blockIdx.y, r0 = blockIdx.x * ROWS;
  const bf16* xb = x + (size_t)brow * N * C;
  bf16* ob = out + (size_t)brow * N * C;

  for (int idx = threadIdx.x; idx < ROWS * C / 8; idx += THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < N) v = *reinterpret_cast<const uint4*>(xb + (size_t)(r0 + r) * C + c8 * 8);
    *reinterpret_cast<uint4*>(XN + r * LD + c8 * 8) = v;
  }
  __syncthreads();
  layer_norm<ROWS, C>(XN, XN, LD, p.gamma, p.beta, eps);
  for (int n0 = 0; n0 < C; n0 += NC) {  // q = bf16(LN(x) Wq^T * scale)
    float acc[ROWS / 16][NC / 64][4];
    zero<ROWS, NC>(acc);
    gemm<ROWS, NC, C>(acc, XN, LD, [&](int c) { return p.wq + (size_t)min(n0 + c, C - 1) * C; },
                      ring);
    each_pair<ROWS, NC>(acc, [&](int r, int c, float v0, float v1) {
      if (n0 + c < C)
        *reinterpret_cast<__nv_bfloat162*>(Q + r * LD + n0 + c) =
            __floats2bfloat162_rn(v0 * scale, v1 * scale);
    });
  }
  __syncthreads();

  // one (16 tokens, head) item per warp at a time; its output overwrites its
  // own q. A head dim that is not a multiple of 16 (40) ends in a half k-step
  // whose upper 8 columns belong to the next head: those q and k fragment
  // registers are zeroed.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const bf16* kb = p.k + (size_t)brow * KV * C;
  const bf16* vb = p.vt + (size_t)brow * C * KV;
  for (int item = warp; item < (ROWS / 16) * H; item += THREADS / 32) {
    const int rg = item % (ROWS / 16), h = item / (ROWS / 16);
    float s[KV / 8][4];
#pragma unroll
    for (int nt = 0; nt < KV / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const bool upper = kk * 16 + 8 < D;
      uint32_t qa[4];
      ldsm_x4(qa, Q + (rg * 16 + (lane & 15)) * LD + h * D + kk * 16 + (lane >> 4) * 8);
      if (!upper) qa[2] = qa[3] = 0u;
#pragma unroll
      for (int nt = 0; nt < KV / 8; ++nt) {
        const bf16* kr = kb + (size_t)(nt * 8 + g) * C + h * D + kk * 16 + tig * 2;
        mma16816(s[nt], qa, ld32(kr), upper ? ld32(kr + 8) : 0u);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < KV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (nt * 8 + tig * 2 + (e & 1) >= L) s[nt][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    }
#pragma unroll
    for (int nt = 0; nt < KV / 8; ++nt)
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
    float o[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int j = 0; j < KV / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * j][0] / sum[0], s[2 * j][1] / sum[0]),
          pack_bf16(s[2 * j][2] / sum[1], s[2 * j][3] / sum[1]),
          pack_bf16(s[2 * j + 1][0] / sum[0], s[2 * j + 1][1] / sum[0]),
          pack_bf16(s[2 * j + 1][2] / sum[1], s[2 * j + 1][3] / sum[1])};
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const bf16* vr = vb + (size_t)(h * D + nt * 8 + g) * KV + j * 16 + tig * 2;
        mma16816(o[nt], pa, ld32(vr), ld32(vr + 8));
      }
    }
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(Q + (rg * 16 + g + hr * 8) * LD + h * D + nt * 8 +
                                           tig * 2) =
            __floats2bfloat162_rn(o[nt][2 * hr], o[nt][2 * hr + 1]);
  }
  __syncthreads();

  for (int n0 = 0; n0 < C; n0 += NC) {  // out = bf16(bf16(o Wo^T + bo) + x)
    float acc[ROWS / 16][NC / 64][4];
    zero<ROWS, NC>(acc);
    gemm<ROWS, NC, C>(acc, Q, LD, [&](int c) { return p.wo + (size_t)min(n0 + c, C - 1) * C; },
                      ring);
    each_pair<ROWS, NC>(acc, [&](int r, int c, float v0, float v1) {
      if (n0 + c >= C || r0 + r >= N) return;
      const size_t off = (size_t)(r0 + r) * C + n0 + c;
      *reinterpret_cast<__nv_bfloat162*>(ob + off) =
          __hadd2(__floats2bfloat162_rn(v0 + p.bo[n0 + c], v1 + p.bo[n0 + c + 1]),
                  *reinterpret_cast<const __nv_bfloat162*>(xb + off));
    });
  }
}

// The LayerNorm alone, 8 rows a block (one per warp), for the bit-exact
// test of its roundings: out (N, C) bf16 and each row's fp32 (mean, inv).
template <int C>
__global__ void __launch_bounds__(THREADS) layer_norm_kernel(const bf16* __restrict__ x,
                                                            const float* __restrict__ gamma,
                                                            const float* __restrict__ beta,
                                                            bf16* __restrict__ out,
                                                            float2* __restrict__ stats, int N,
                                                            float eps) {
  constexpr int ROWS = THREADS / 32, LD = C + 8;
  __shared__ __align__(16) unsigned char raw[ROWS * LD * 2];
  __shared__ float2 st[ROWS];
  bf16* T = reinterpret_cast<bf16*>(raw);
  const int r0 = blockIdx.x * ROWS;
  for (int idx = threadIdx.x; idx < ROWS * C / 8; idx += THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < N) v = *reinterpret_cast<const uint4*>(x + (size_t)(r0 + r) * C + c8 * 8);
    *reinterpret_cast<uint4*>(T + r * LD + c8 * 8) = v;
  }
  __syncthreads();
  layer_norm<ROWS, C>(T, T, LD, gamma, beta, eps, st);
  __syncthreads();
  for (int idx = threadIdx.x; idx < ROWS * C / 8; idx += THREADS) {
    const int r = idx / (C / 8), c8 = idx % (C / 8);
    if (r0 + r < N)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * C + c8 * 8) =
          *reinterpret_cast<const uint4*>(T + r * LD + c8 * 8);
  }
  if (threadIdx.x < ROWS && r0 + threadIdx.x < N) stats[r0 + threadIdx.x] = st[threadIdx.x];
}

template <int C>
cudaError_t launch_head(const void* x, const void* wpi, const void* bpi, const AttnArgs& a1,
                        const AttnArgs& a2, void* out, long long rows, int N, int L, float scale,
                        float eps, cudaStream_t st) {
  cudaError_t err = prepare(head_kernel<C>, Head<C>::SMEM);
  if (err != cudaSuccess) return err;
  head_kernel<C><<<(unsigned)(rows / HROWS), THREADS, Head<C>::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpi), static_cast<const float*>(bpi),
      a1, a2, static_cast<bf16*>(out), N, L, scale, eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_tail(const void* x, const void* r, const void* g3, const void* b3,
                        const void* w0, const void* b0, const void* w2, const void* b2,
                        const void* wpo, const void* bpo, void* out, int N, float eps,
                        cudaStream_t st) {
  cudaError_t err = prepare(tail_kernel<C>, Tail<C>::SMEM);
  if (err != cudaSuccess) return err;
  tail_kernel<C><<<(N + TROWS - 1) / TROWS, THREADS, Tail<C>::SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(r), static_cast<const float*>(g3),
      static_cast<const float*>(b3), static_cast<const bf16*>(w0), static_cast<const float*>(b0),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2), static_cast<const bf16*>(wpo),
      static_cast<const float*>(bpo), static_cast<bf16*>(out), N, eps);
  return cudaGetLastError();
}

template <int C, int D>
cudaError_t launch_single(const void* x, const AttnArgs& a, void* out, int B, int N, int L,
                          float scale, float eps, cudaStream_t st) {
  cudaError_t err = prepare(single_kernel<C, D>, Single<C>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Single<C>::ROWS - 1) / Single<C>::ROWS, B);
  single_kernel<C, D><<<grid, THREADS, Single<C>::SMEM, st>>>(
      static_cast<const bf16*>(x), a, static_cast<bf16*>(out), N, L, scale, eps);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_layer_norm(const void* x, const void* g, const void* b, void* out, void* stats,
                              int N, float eps, cudaStream_t st) {
  layer_norm_kernel<C><<<(N + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<bf16*>(out), static_cast<float2*>(stats), N, eps);
  return cudaGetLastError();
}

AttnArgs attn_args(const void* g, const void* b, const void* wq, const void* wo, const void* bo,
                   const void* k, const void* vt) {
  return {static_cast<const float*>(g), static_cast<const float*>(b),
          static_cast<const bf16*>(wq), static_cast<const bf16*>(wo),
          static_cast<const float*>(bo), static_cast<const bf16*>(k),
          static_cast<const bf16*>(vt)};
}

}  // namespace

// x, out (B, N, C) bf16 with N % 64 == 0; wpi, wq*, wo* (C, C) bf16;
// bpi, g*, b*, bo* (C) fp32; k* (B, 80, C) bf16 zero-padded past L text
// keys; vt* (B, C, 80) bf16 the transposed, padded values. C in {128, 256,
// 512}, head dim 64, L <= 80. Returns cudaGetLastError().
extern "C" int cross_attention_head_bf16(
    const void* x, const void* wpi, const void* bpi, const void* g1, const void* b1,
    const void* wq1, const void* wo1, const void* bo1, const void* k1, const void* vt1,
    const void* g2, const void* b2, const void* wq2, const void* wo2, const void* bo2,
    const void* k2, const void* vt2, void* out, int B, int N, int C, int L, float scale,
    float eps, void* stream) {
  if (B < 1 || N < HROWS || N % HROWS || L < 1 || L > KV) return (int)cudaErrorInvalidValue;
  const AttnArgs a1 = attn_args(g1, b1, wq1, wo1, bo1, k1, vt1);
  const AttnArgs a2 = attn_args(g2, b2, wq2, wo2, bo2, k2, vt2);
  const long long rows = (long long)B * N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch_head<128>(x, wpi, bpi, a1, a2, out, rows, N, L, scale, eps, st);
    case 256: return (int)launch_head<256>(x, wpi, bpi, a1, a2, out, rows, N, L, scale, eps, st);
    case 512: return (int)launch_head<512>(x, wpi, bpi, a1, a2, out, rows, N, L, scale, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, r, out (N, C) bf16; w0 (8C, C), w2 (C, 4C), wpo (C, C) bf16; g3, b3,
// b0 (8C), b2, bpo fp32. C in {128, 256, 512}. Returns cudaGetLastError().
extern "C" int transformer_tail_bf16(const void* x, const void* r, const void* g3,
                                     const void* b3, const void* w0, const void* b0,
                                     const void* w2, const void* b2, const void* wpo,
                                     const void* bpo, void* out, int N, int C, float eps,
                                     void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch_tail<128>(x, r, g3, b3, w0, b0, w2, b2, wpo, bpo, out, N, eps, st);
    case 256: return (int)launch_tail<256>(x, r, g3, b3, w0, b0, w2, b2, wpo, bpo, out, N, eps, st);
    case 512: return (int)launch_tail<512>(x, r, g3, b3, w0, b0, w2, b2, wpo, bpo, out, N, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, out (B, N, C) bf16, any N >= 1; wq, wo (C, C) bf16; g, b, bo (C) fp32;
// k (B, 80, C) bf16 zero-padded past L text keys; vt (B, C, 80) bf16 the
// transposed, padded values. (C, D) in {(320, 40), (640, 80), (1024, 128),
// (1280, 160), (512, 64)}, L <= 80. Returns cudaGetLastError().
extern "C" int fused_ln_cross_attention_bf16(const void* x, const void* g, const void* b,
                                             const void* wq, const void* wo, const void* bo,
                                             const void* k, const void* vt, void* out, int B,
                                             int N, int C, int D, int L, float scale, float eps,
                                             void* stream) {
  if (B < 1 || N < 1 || L < 1 || L > KV) return (int)cudaErrorInvalidValue;
  const AttnArgs a = attn_args(g, b, wq, wo, bo, k, vt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 320 && D == 40) return (int)launch_single<320, 40>(x, a, out, B, N, L, scale, eps, st);
  if (C == 640 && D == 80) return (int)launch_single<640, 80>(x, a, out, B, N, L, scale, eps, st);
  if (C == 1024 && D == 128)
    return (int)launch_single<1024, 128>(x, a, out, B, N, L, scale, eps, st);
  if (C == 1280 && D == 160)
    return (int)launch_single<1280, 160>(x, a, out, B, N, L, scale, eps, st);
  if (C == 512 && D == 64) return (int)launch_single<512, 64>(x, a, out, B, N, L, scale, eps, st);
  return (int)cudaErrorInvalidValue;
}

// The kernels' LayerNorm alone: x, out (N, C) bf16; g, b (C) fp32; stats
// (N, 2) fp32 each row's (mean, inv). C in {128, 256, 320, 512, 640, 1024,
// 1280}. Returns cudaGetLastError().
extern "C" int layer_norm_bf16(const void* x, const void* g, const void* b, void* out,
                               void* stats, int N, int C, float eps, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return (int)launch_layer_norm<128>(x, g, b, out, stats, N, eps, st);
    case 256: return (int)launch_layer_norm<256>(x, g, b, out, stats, N, eps, st);
    case 320: return (int)launch_layer_norm<320>(x, g, b, out, stats, N, eps, st);
    case 512: return (int)launch_layer_norm<512>(x, g, b, out, stats, N, eps, st);
    case 640: return (int)launch_layer_norm<640>(x, g, b, out, stats, N, eps, st);
    case 1024: return (int)launch_layer_norm<1024>(x, g, b, out, stats, N, eps, st);
    case 1280: return (int)launch_layer_norm<1280>(x, g, b, out, stats, N, eps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
