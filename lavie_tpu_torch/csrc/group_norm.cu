// GroupNorm of the UNet, its transformers and the VAE over x (N, P, C),
// channels last, bf16, with the SiLU that follows it and a per-(n, c) shift
// and a per-channel bias added before it folded in:
//   y = bf16(bf16(x * w[n,c]) + u[n,c])                      (silu off)
//   y = bf16(t / (1 + e^-t)),  t = bf16(bf16(x * w) + u)       (silu on)
//   w = gamma * rsqrt(var_g + eps),  u = beta - mean_g * w (+ s * w)
//   s = shift[n,c] + bias_in[c]  (fp32, either absent)
// where g is channel c's group and the statistics of group g are taken over
// the P rows of n and the group's C / G channels, of x + s when a shift or a
// bias is given (the bias: a convolution's, which ATen would add to its
// output as a pass of its own). N is the videos (statistics over all
// frames) or the frames (per-frame statistics). The two roundings of the normalisation are the
// port's plain route's (x * w and + u as two bf16 ops), as is its SiLU
// (F.silu: t / (1 + e^-t) in fp32, rounded once); given the same (w, u), y
// is the plain route's bit for bit. With a shift the plain route rounds x +
// shift to bf16 first; here s moves only the statistics and u (u + s * w),
// so that rounding drops out.
//
// Replaces no Pallas kernel: the JAX package leaves GroupNorm to XLA
// (lavie_tpu/nn/layers.py, groupnorm_affine: per-channel fp32 moments
// folded into a per-(batch, channel) affine). It replaces the port's eager
// GroupNorm (a fp32 copy of x, var_mean, a dozen ops on (N, G) and (N, C),
// two broadcast bf16 ops, and F.silu and the time-embedding add beside it):
// about 24 bytes of HBM an element, against 6 here.
//
// What bounds it on the H100: bytes. x is read twice (statistics, then the
// normalisation) and y written once, 6 bytes an element: the base UNet's
// largest call (2 x 40960 x 320) moves 157 MB, 47 us at 3.35 TB/s. The
// operations (a few fp32 flops and, with SiLU, one exponential an element)
// are far below the card's rates.
//
// What the design does about it: two kernels, launched back to back on the
// stream by one call.
//   gn_stats_kernel: grid (channel tiles, slabs, N). A block takes the rows
//     of one slab of n and 8 * tcv channels (whole groups), thread (cv, y) the
//     8 channels of vector cv (one 16-byte load a row) of every rl-th row,
//     four loads in flight. Sums are of x - k, k the slab's first row, so
//     that they stay accurate when |mean| >> std; the block adds its row
//     lanes in order and writes the slab's per-channel (mean, M2). The last
//     block of an (n, channel tile) to finish (a counter it resets) merges
//     the slabs' partials in a fixed order by Chan's formula, adds s to
//     each channel's mean (M2 does not move under a shift), folds the
//     channels into their groups by the same formula and writes w and u in
//     fp32 and bf16. No atomics go into the sums: the result is the same
//     from run to run.
//   gn_apply_kernel: grid (blocks, N), 256 threads, n's bf16 (w, u) rows in
//     shared memory; 16 bytes of x in and of y out a thread a step, four
//     steps in flight; the SiLU a flag of the call (a template instance
//     without it spilled 8 bytes under ptxas, one with a uniform branch
//     does not).

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int APPLY_THREADS = 256;
constexpr int MAX_STATS_THREADS = 512;
constexpr int FLAG_SILU = 1, FLAG_PARAM_BF16 = 2, FLAG_SHIFT_BF16 = 4, FLAG_BIAS_IN_BF16 = 8;

__device__ __forceinline__ float load_f(const void* p, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t = __bfloat1622float2(h[q]);
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
}

// s1 += x - k, s2 += (x - k)^2 for 8 channels; k the slab's first row, packed bf16
__device__ __forceinline__ void accumulate8(uint4 v, uint4 kv, float (&s1)[8], float (&s2)[8]) {
  float f[8], k[8];
  unpack8(v, f);
  unpack8(kv, k);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = f[j] - k[j];
    s1[j] += d;
    s2[j] = fmaf(d, d, s2[j]);
  }
}

// (mean_a, m2_a) of n_a rows <- the merge of itself and (mean_b, m2_b) of
// n_b rows, Chan's formula; fb = n_b / (n_a + n_b), the same for every
// channel of a merge
__device__ __forceinline__ void chan_merge(float& ma, float& m2a, float mb, float m2b, float na,
                                           float fb) {
  const float d = mb - ma;
  ma += d * fb;
  m2a += m2b + d * d * na * fb;
}

// bf16(bf16(v * w) + u) for two channels packed in a 32-bit word: mul.rn and
// add.rn name their rounding, so ptxas cannot fuse them into one fma
// (temporal_resblock.cu's gn_affine2)
__device__ __forceinline__ uint32_t affine2(uint32_t v, uint32_t w, uint32_t u) {
  uint32_t p, t;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(p) : "r"(v), "r"(w));
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(t) : "r"(p), "r"(u));
  return t;
}

// F.silu's order: t / (1 + e^-t) in fp32, rounded once
__device__ __forceinline__ uint32_t silu2(uint32_t t) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t));
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fdiv_rn(f.x, 1.f + expf(-f.x)),
                                                 __fdiv_rn(f.y, 1.f + expf(-f.y)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

struct StatsArgs {
  const uint4* x;        // (N, P, C / 8)
  const void* gamma;     // (C), fp32 or bf16
  const void* beta;      // (C)
  const void* shift;     // (N, C) or null
  const void* bias_in;   // (C) or null
  float* part;           // (2, N, slabs, C): per-slab mean, then M2
  float* wu;             // (2, N, C): w, then u
  __nv_bfloat16* wu_bf;  // (2, N, C)
  int* counters;         // (N, ctiles), zero between calls
  int N, P, C, G, tcv, rl, slabs, slab_rows, flags;
  float eps;
};

// s of (n, c): shift[n, c] + bias_in[c] in fp32, an absent term 0
__device__ __forceinline__ float shift_at(const StatsArgs& a, int n, int c, bool sbf, bool bbf) {
  const float s = a.shift ? load_f(a.shift, (size_t)n * a.C + c, sbf) : 0.f;
  return a.bias_in ? __fadd_rn(s, load_f(a.bias_in, c, bbf)) : s;
}

// dynamic shared memory: 2 * 8 floats a thread
__global__ void __launch_bounds__(MAX_STATS_THREADS, 2) gn_stats_kernel(const StatsArgs a) {
  extern __shared__ float red[];
  __shared__ int last;
  const int ct = blockIdx.x, slab = blockIdx.y, n = blockIdx.z;
  const int ctiles = gridDim.x, cvs = a.C / 8, nthreads = a.tcv * a.rl;
  const int tid = threadIdx.x, cv = tid % a.tcv, y = tid / a.tcv;
  const int c0 = (ct * a.tcv + cv) * 8;
  const int r0 = slab * a.slab_rows, r1 = min(a.P, r0 + a.slab_rows);
  float* red1 = red;                      // [thread][8]
  float* red2 = red + (size_t)nthreads * 8;

  const uint4* src = a.x + (size_t)n * a.P * cvs + c0 / 8;
  const uint4 kv = src[(size_t)r0 * cvs];
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  const int step = a.rl;
  int r = r0 + y;
  for (; r + 3 * step < r1; r += 4 * step) {
    const uint4 v0 = src[(size_t)r * cvs], v1 = src[(size_t)(r + step) * cvs];
    const uint4 v2 = src[(size_t)(r + 2 * step) * cvs], v3 = src[(size_t)(r + 3 * step) * cvs];
    accumulate8(v0, kv, s1, s2);
    accumulate8(v1, kv, s1, s2);
    accumulate8(v2, kv, s1, s2);
    accumulate8(v3, kv, s1, s2);
  }
  for (; r < r1; r += step) accumulate8(src[(size_t)r * cvs], kv, s1, s2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red1[tid * 8 + j] = s1[j];
    red2[tid * 8 + j] = s2[j];
  }
  __syncthreads();
  const size_t nsc = (size_t)a.N * a.slabs * a.C;  // floats of one partial array
  if (y == 0) {
    for (int l = 1; l < a.rl; ++l) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1[j] += red1[(l * a.tcv + cv) * 8 + j];
        s2[j] += red2[(l * a.tcv + cv) * 8 + j];
      }
    }
    float k[8];
    unpack8(kv, k);
    const float cnt = (float)(r1 - r0);
    float* pm = a.part + ((size_t)n * a.slabs + slab) * a.C + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pm[j] = k[j] + s1[j] / cnt;
      pm[nsc + j] = fmaxf(s2[j] - s1[j] * (s1[j] / cnt), 0.f);
    }
    __threadfence();  // the partials are seen before the count that follows
  }
  // the last block of (n, ct) to finish merges the slabs
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.counters[n * ctiles + ct], 1) == a.slabs - 1;
  __syncthreads();
  if (!last) return;

  const int cpg = a.C / a.G, width = 8 * a.tcv;
  const bool pbf = a.flags & FLAG_PARAM_BF16, sbf = a.flags & FLAG_SHIFT_BF16,
             bbf = a.flags & FLAG_BIAS_IN_BF16, shifted = a.shift || a.bias_in;
  float ma[8], m2a[8], na = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ma[j] = m2a[j] = 0.f;
  for (int s = y; s < a.slabs; s += a.rl) {
    const float* pm = a.part + ((size_t)n * a.slabs + s) * a.C + c0;
    float mb[8], qb[8];
    *reinterpret_cast<float4*>(mb) = __ldcg(reinterpret_cast<const float4*>(pm));
    *reinterpret_cast<float4*>(mb + 4) = __ldcg(reinterpret_cast<const float4*>(pm + 4));
    *reinterpret_cast<float4*>(qb) = __ldcg(reinterpret_cast<const float4*>(pm + nsc));
    *reinterpret_cast<float4*>(qb + 4) = __ldcg(reinterpret_cast<const float4*>(pm + nsc + 4));
    const float nb = (float)(min(a.P, (s + 1) * a.slab_rows) - s * a.slab_rows);
    const float fb = nb / (na + nb);
#pragma unroll
    for (int j = 0; j < 8; ++j) chan_merge(ma[j], m2a[j], mb[j], qb[j], na, fb);
    na += nb;
  }
  __syncthreads();  // red is reused
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red1[tid * 8 + j] = ma[j];
    red2[tid * 8 + j] = m2a[j];
  }
  // this thread's first channel of the fold below: gamma, beta, s read
  // now, while the lanes merge
  const int cf = ct * width + tid;
  float gam = 0.f, bet = 0.f, sh = 0.f;
  if (tid < width) {
    gam = load_f(a.gamma, cf, pbf);
    bet = load_f(a.beta, cf, pbf);
    if (shifted) sh = shift_at(a, n, cf, sbf, bbf);
  }
  __syncthreads();
  if (y == 0) {  // lane l's rows: the slabs s = l, l + rl, ...
    for (int l = 1; l < a.rl && l < a.slabs; ++l) {
      float nb = 0.f;
      for (int s = l; s < a.slabs; s += a.rl)
        nb += (float)(min(a.P, (s + 1) * a.slab_rows) - s * a.slab_rows);
      const float fb = nb / (na + nb);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        chan_merge(ma[j], m2a[j], red1[(l * a.tcv + cv) * 8 + j],
                   red2[(l * a.tcv + cv) * 8 + j], na, fb);
      na += nb;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red1[cv * 8 + j] = ma[j];
      red2[cv * 8 + j] = m2a[j];
    }
  }
  __syncthreads();
  // each channel's mean moves by its s (M2 does not)
  for (int i = tid; i < width; i += nthreads)
    red1[i] += i == tid ? sh : (shifted ? shift_at(a, n, ct * width + i, sbf, bbf) : 0.f);
  __syncthreads();
  // fold each channel's group: mean_g = the channels' mean (equal counts),
  // M2_g = sum of M2_c + P (mean_c - mean_g)^2, every thread of a group in
  // the same order
  for (int i = tid; i < width; i += nthreads) {
    const int g0 = i / cpg * cpg, c = ct * width + i;
    float mg = 0.f;
    for (int q = g0; q < g0 + cpg; ++q) mg += red1[q];
    mg /= (float)cpg;
    float m2 = 0.f;
    for (int q = g0; q < g0 + cpg; ++q) {
      const float d = red1[q] - mg;
      m2 += red2[q] + (float)a.P * (d * d);
    }
    const float inv = rsqrtf(m2 / ((float)a.P * (float)cpg) + a.eps);
    const bool first = i == tid;
    const float w = __fmul_rn(inv, first ? gam : load_f(a.gamma, c, pbf));
    float u = __fsub_rn(first ? bet : load_f(a.beta, c, pbf), __fmul_rn(mg, w));
    if (shifted) u = __fadd_rn(u, __fmul_rn(first ? sh : shift_at(a, n, c, sbf, bbf), w));
    const size_t o = (size_t)n * a.C + c, nc = (size_t)a.N * a.C;
    a.wu[o] = w;
    a.wu[nc + o] = u;
    a.wu_bf[o] = __float2bfloat16_rn(w);
    a.wu_bf[nc + o] = __float2bfloat16_rn(u);
  }
  if (tid == 0) a.counters[n * ctiles + ct] = 0;
}

// the normalisation of 8 channels (16 bytes of x), w and u from shared memory
__device__ __forceinline__ uint4 normalise8(uint4 v, const uint4* wus, int cvs, int cv, bool silu) {
  const uint4 w = wus[cv], u = wus[cvs + cv];
  v.x = affine2(v.x, w.x, u.x);
  v.y = affine2(v.y, w.y, u.y);
  v.z = affine2(v.z, w.z, u.z);
  v.w = affine2(v.w, w.w, u.w);
  if (silu) {
    v.x = silu2(v.x);
    v.y = silu2(v.y);
    v.z = silu2(v.z);
    v.w = silu2(v.w);
  }
  return v;
}

// the channel vector `adv` vectors on, for adv < cvs
__device__ __forceinline__ int advance(int cv, int adv, int cvs) {
  cv += adv;
  return cv >= cvs ? cv - cvs : cv;
}

// y = the normalisation of x, the 16-byte vectors [blockIdx.x * chunk, ...)
// of n, whole rows; dynamic shared memory: n's bf16 w and u rows
__global__ void __launch_bounds__(APPLY_THREADS) gn_apply_kernel(
    const uint4* __restrict__ x, const __nv_bfloat16* __restrict__ wu_bf, uint4* __restrict__ y,
    int N, long long per_n, long long chunk, int C, bool silu) {
  // chunk: whole rows (a multiple of C / 8 vectors), so a block starts at channel 0
  extern __shared__ uint4 wus[];  // [C / 8] w vectors, then [C / 8] u vectors
  const int n = blockIdx.y, cvs = C / 8;
  const long long lo = blockIdx.x * chunk;
  if (lo >= per_n) return;
  const uint4* wsrc = reinterpret_cast<const uint4*>(wu_bf + (size_t)n * C);
  const uint4* usrc = reinterpret_cast<const uint4*>(wu_bf + (size_t)N * C + (size_t)n * C);
  for (int i = threadIdx.x; i < cvs; i += APPLY_THREADS) {
    wus[i] = wsrc[i];
    wus[cvs + i] = usrc[i];
  }
  __syncthreads();
  const int len = (int)min(chunk, per_n - lo);  // vectors of this block, under 2^31
  const uint4* xs = x + (size_t)n * per_n + lo;
  uint4* ys = y + (size_t)n * per_n + lo;
  const int adv = APPLY_THREADS % cvs;  // the channel vector's step a step
  constexpr int S = APPLY_THREADS;
  int i = threadIdx.x, cv = i % cvs;
  for (; i + 3 * S < len; i += 4 * S) {
    const int c1 = advance(cv, adv, cvs), c2 = advance(c1, adv, cvs), c3 = advance(c2, adv, cvs);
    const uint4 v0 = xs[i], v1 = xs[i + S], v2 = xs[i + 2 * S], v3 = xs[i + 3 * S];
    ys[i] = normalise8(v0, wus, cvs, cv, silu);
    ys[i + S] = normalise8(v1, wus, cvs, c1, silu);
    ys[i + 2 * S] = normalise8(v2, wus, cvs, c2, silu);
    ys[i + 3 * S] = normalise8(v3, wus, cvs, c3, silu);
    cv = advance(c3, adv, cvs);
  }
  for (; i < len; i += S) {
    ys[i] = normalise8(xs[i], wus, cvs, cv, silu);
    cv = advance(cv, adv, cvs);
  }
}

}  // namespace

// One GroupNorm: the statistics into wu (fp32) and wu_bf (bf16), (2, N, C)
// each, then, when y is not null, the normalisation of x into y. shift (N,
// C) and bias_in (C) may be null. part: (2, N, slabs, C) fp32 scratch;
// counters: N * (C / 8 / tcv) ints, zero (each call leaves them zero).
// flags: 1 SiLU, 2 gamma and beta bf16 (else fp32), 4 shift bf16 (else
// fp32), 8 bias_in bf16 (else fp32). The plan (tcv, rl, slabs, slab_rows,
// apply_blocks) is kernels/group_norm.py::launch_plan's.
extern "C" int group_norm_bf16(const void* x, const void* gamma, const void* beta,
                               const void* shift, const void* bias_in, void* y, void* wu,
                               void* wu_bf, void* part, void* counters, int N, int P, int C,
                               int G, int tcv, int rl, int slabs, int slab_rows, int apply_blocks,
                               int flags, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cvs = C / 8;
  if (N < 1 || P < 1 || C < 8 || C % 8 || G < 1 || C % G || tcv < 1 || cvs % tcv || rl < 1 ||
      tcv * rl > MAX_STATS_THREADS || (8 * tcv) % (C / G) || slabs < 1 || slab_rows < 1 ||
      (long long)(slabs - 1) * slab_rows >= P || (long long)slabs * slab_rows < P ||
      apply_blocks < 1 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return (int)cudaErrorInvalidValue;
  const StatsArgs a{static_cast<const uint4*>(x), gamma, beta, shift, bias_in,
                    static_cast<float*>(part),
                    static_cast<float*>(wu), static_cast<__nv_bfloat16*>(wu_bf),
                    static_cast<int*>(counters), N, P, C, G, tcv, rl, slabs, slab_rows, flags, eps};
  const int threads = tcv * rl;
  const size_t stats_smem = (size_t)threads * 16 * sizeof(float);
  gn_stats_kernel<<<dim3(cvs / tcv, slabs, N), threads, stats_smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || y == nullptr) return (int)err;
  const long long per_n = (long long)P * cvs;
  const long long chunk = (long long)((P + apply_blocks - 1) / apply_blocks) * cvs;  // whole rows
  if (chunk >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)cvs * sizeof(uint4);
  gn_apply_kernel<<<dim3(apply_blocks, N), APPLY_THREADS, smem, st>>>(
      static_cast<const uint4*>(x), static_cast<const __nv_bfloat16*>(wu_bf),
      static_cast<uint4*>(y), N, per_n, chunk, C, (flags & FLAG_SILU) != 0);
  return (int)cudaGetLastError();
}
