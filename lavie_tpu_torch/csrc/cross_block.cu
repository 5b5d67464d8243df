// The VSR only-cross transformer block as two fused passes around the
// frame-axis temporal attention (the temporal attention needs the frame
// axis and forces the boundary):
//   head: xp = x Wpi^T + bpi; x1 = xp + Attn(LN1(xp); k1, v1);
//         x2 = x1 + Attn(LN2(x1); k2, v2)           (8 heads x 64, 77 text keys)
//   tail: y = (GEGLU(LN3(x)) + x) Wpo^T + bpo + r   (hidden|gate, erf gelu)
// Weights bf16 in nn.Linear (out, in) layout; biases and LayerNorm
// parameters fp32. Arithmetic as the TPU kernels: LayerNorm statistics in
// fp32 with the elementwise steps rounded to bf16, products accumulated in
// fp32, q scaled in fp32 then rounded, fp32 softmax whose probabilities are
// rounded to bf16 before P.V, each residual added in bf16.
//
// Replaces: lavie_tpu/kernels/cross_block.py
//   cross_attention_head (_head_3d, body _head_kernel) -> cross_attention_head_bf16
//   transformer_tail     (_tail_3d, body _tail_kernel) -> transformer_tail_bf16
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int THREADS = 256;  // 8 warps
constexpr int WLD = 24;       // weight-stage row stride: 16 channels + 8 pad
constexpr int HEAD_D = 64;
constexpr int KV = 80;        // text keys, zero-padded

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc += A (ROWS x K, shared, row stride lda) * W^T over NCOLS output
// columns, where output column c reads the K contiguous weights at wrow(c).
// Warp w owns columns [w*NCOLS/8, (w+1)*NCOLS/8) for all ROWS rows; its
// accumulator element (mt, nt, e) is row mt*16 + g + (e/2)*8, column
// w*NCOLS/8 + nt*8 + tig*2 + e%2. All 256 threads call it; it begins and
// ends with a barrier-ordered ring, so A may have been written just before.
template <int ROWS, int NCOLS, int K, typename RowFn>
__device__ __forceinline__ void gemm(float (&acc)[ROWS / 16][NCOLS / 64][4], const bf16* A,
                                     int lda, RowFn wrow, bf16* ring) {
  constexpr int MT = ROWS / 16, NT = NCOLS / 64, KS = K / 16;
  static_assert(NT % 2 == 0, "pairs of n8 tiles");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto load = [&](int s, int st) {
    for (int idx = tid; idx < NCOLS * 2; idx += THREADS) {
      const int c = idx >> 1, h = idx & 1;
      cp_async16(ring + (st * NCOLS + c) * WLD + h * 8, wrow(c) + s * 16 + h * 8);
    }
  };
  load(0, 0);
  cp_async_commit();
  for (int s = 0; s < KS; ++s) {
    if (s + 1 < KS) {
      load(s + 1, (s + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* wt = ring + (s & 1) * NCOLS * WLD;
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], A + (mt * 16 + (lane & 15)) * lda + s * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, wt + (warp * (NCOLS / 8) + np * 16 + (lane & 7) + (lane >> 4) * 8) * WLD +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma16816(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
    __syncthreads();
  }
}

template <int ROWS, int NCOLS>
__device__ __forceinline__ void zero(float (&acc)[ROWS / 16][NCOLS / 64][4]) {
#pragma unroll
  for (int mt = 0; mt < ROWS / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < NCOLS / 64; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// Visit each accumulator element as fn(row, col, value) with the pairs of
// adjacent columns together: fn(row, col, v0, v1).
template <int ROWS, int NCOLS, typename Fn>
__device__ __forceinline__ void each_pair(const float (&acc)[ROWS / 16][NCOLS / 64][4], Fn fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < ROWS / 16; ++mt)
#pragma unroll
    for (int nt = 0; nt < NCOLS / 64; ++nt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        fn(mt * 16 + g + hr * 8, warp * (NCOLS / 8) + nt * 8 + tig * 2, acc[mt][nt][2 * hr],
           acc[mt][nt][2 * hr + 1]);
}

// LayerNorm of ROWS rows of C: fp32 mean and E[x^2], then
// (x - bf16(mean)) * bf16(inv) * bf16(gamma) + bf16(beta), each step rounded.
template <int ROWS, int C>
__device__ __forceinline__ void layer_norm(const bf16* src, bf16* dst, int ld,
                                           const float* gamma, const float* beta, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * 2; c < C; c += 64) {
      const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + r * ld + c));
      s1 += v.x + v.y;
      s2 += v.x * v.x + v.y * v.y;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mean = s1 / C;
    const float inv = rsqrtf(fmaxf(s2 / C - mean * mean, 0.f) + eps);
    const bf16 mb = __float2bfloat16(mean), ib = __float2bfloat16(inv);
    for (int c = lane; c < C; c += 32) {
      const bf16 xn = __hmul(__hsub(src[r * ld + c], mb), ib);
      dst[r * ld + c] = __hadd(__hmul(xn, __float2bfloat16(gamma[c])), __float2bfloat16(beta[c]));
    }
  }
}

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

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
