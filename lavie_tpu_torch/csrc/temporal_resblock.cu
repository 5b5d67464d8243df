// Fused GroupNorm-apply -> SiLU -> k-tap frame-axis convolution of the VSR
// ResnetBlock3DCNN, with the conv bias (time embedding folded in) and the
// block residual in the fp32 accumulator:
//   y[b,f,s,o] = bias[b,o] + sum_j sum_c act[b,f+j-k/2,s,c] W[j,o,c] (+ res[b,f,s,o])
//   act = bf16(silu_fp32(bf16(bf16(x * bf16(w[b,c])) + bf16(u[b,c]))))
// or, with activation "none", act = x (w and u are not read). Frames
// outside [0, F) contribute nothing (zero padding of the activated input).
// x, W, res, y bf16; w, u, bias fp32. Optionally (emit_stats) it also
// returns the per-(b, o) sums over (F, S) of y and of y*y, in fp32, of the
// bf16-rounded values it stores: the moments a following GroupNorm needs,
// without a second read of y.
//
// Replaces: lavie_tpu/kernels/temporal_resblock.py
//   gn_silu_tconv     (_conv_4d, body _kernel)      frame-major (B, F, S, C)
//   gn_silu_tconv_sfc (_conv_sfc, body _kernel_sfc) token-major (B, S, F, C)
// with their float options (activation "silu" | "none", emit_stats). The
// port keeps video frame-major at both call sites, so this kernel takes that
// layout only (XLA's conv layout is what made the token-major form).
//
// What bounds it on the H100: tensor-core operations. At the VSR L0 level
// (S = 163840, C = O = 256, F = 8, k = 5) the taps that land inside the
// window are 34 of 40, 2*34*S*C*O = 0.73 TFLOP, ~0.74 ms at 989 TFLOP/s,
// against 2*2*F*S*C bytes (1.3 GB, 0.40 ms at 3.35 TB/s). The unfused chain
// would also write and read back the normalised and activated tensors. The
// statistics add O(F*S*O) flops and 2*B*F*ceil(S/128)*O*4 bytes of partial
// sums (21 MB at L0, against the 671 MB read of y they save).
//
// What the design does about it: it is a GEMM per (batch, frame) whose
// A operand is produced on the fly. A block owns 128 positions x 128 output
// channels of one frame and walks K = (valid taps) x C in chunks of 32: the
// x chunk of the source frame is loaded into registers one iteration ahead,
// normalised, activated and rounded as it is written to shared memory; the
// tap's weight chunk arrives by cp.async. Both are double-buffered. 8 warps
// (4 x 2) each own a 32 x 64 accumulator tile on mma.sync m16n8k16 (bf16 in,
// fp32 accumulate, fragments by ldmatrix). Shared rows are padded by 16
// bytes so ldmatrix's eight row reads hit distinct banks. The activated
// input is recomputed for each tap and each output tile: elementwise work,
// small next to the products. Later work (ROADMAP): wgmma, TMA, keeping the
// activated frame tiles resident across taps.
//
// Statistics: each block sums its rounded output tile over its valid rows
// (the ragged S tail masked), first across the accumulator fragment's row
// lanes by warp shuffles, then across the four M-warps through shared
// memory, and writes one row of column partials per block to an fp32
// scratch (B, F*ceil(S/128), O). colsum_kernel then sums the partials 128
// rows per block, in a fixed order, pass after pass until one row is left.
// No atomics: the sums are the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // shared row stride (elements)
constexpr int THREADS = 256;
constexpr int MAX_C = 1024;
constexpr int RED_ROWS = 128;  // partial rows one colsum_kernel block sums

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// part1, part2: (B, F*gridDim.x, O) column partials of y and y*y, or null
template <bool SILU>
__global__ void __launch_bounds__(THREADS) tconv_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wn,
    const float* __restrict__ un, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ y, float* __restrict__ part1, float* __restrict__ part2, int F,
    int S, int C, int O, int K) {
  __shared__ __align__(16) __nv_bfloat16 as[2][BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 bs[2][BN * LDS];
  __shared__ __nv_bfloat16 wsh[MAX_C], ush[MAX_C];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 3, wn_ = warp >> 2;
  const int s0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int b = blockIdx.z / F, f = blockIdx.z - b * F;
  const int pad = K / 2;

  // element (b, f, s, 0) of an activation with `ch` channels
  auto at = [&](int ff, int s, int ch) -> size_t {
    return (((size_t)b * F + ff) * S + s) * ch;
  };

  if (SILU) {
    for (int c = tid; c < C; c += THREADS) {
      wsh[c] = __float2bfloat16(wn[(size_t)b * C + c]);
      ush[c] = __float2bfloat16(un[(size_t)b * C + c]);
    }
  }

  const int jlo = max(0, pad - f), jhi = min(K, F + pad - f);
  const int kchunks = C / BK;
  const int n_it = (jhi - jlo) * kchunks;

  // this thread's two 16-byte pieces of each A and B chunk
  uint4 areg[2];
  auto load_a = [&](int it) {
    const int j = jlo + it / kchunks, k0 = (it % kchunks) * BK;
    const int fsrc = f + j - pad;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * THREADS, row = idx >> 2, c8 = idx & 3;
      areg[r] = make_uint4(0, 0, 0, 0);
      if (s0 + row < S)
        areg[r] = *reinterpret_cast<const uint4*>(x + at(fsrc, s0 + row, C) + k0 + c8 * 8);
    }
  };
  auto store_a = [&](int it, int stage) {
    const int k0 = (it % kchunks) * BK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * THREADS, row = idx >> 2, c8 = idx & 3;
      __nv_bfloat16 v[8];
      *reinterpret_cast<uint4*>(v) = areg[r];
      if (SILU) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = k0 + c8 * 8 + e;
          const float t = __bfloat162float(__hadd(__hmul(v[e], wsh[c]), ush[c]));
          v[e] = __float2bfloat16(t / (1.f + expf(-t)));
        }
      }
      if (s0 + row >= S) *reinterpret_cast<uint4*>(v) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&as[stage][row * LDS + c8 * 8]) = *reinterpret_cast<uint4*>(v);
    }
  };
  auto load_b = [&](int it, int stage) {
    const int j = jlo + it / kchunks, k0 = (it % kchunks) * BK;
    const __nv_bfloat16* wj = wt + (size_t)j * O * C;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int idx = tid + r * THREADS, row = idx >> 2, c8 = idx & 3;
      cp_async16(&bs[stage][row * LDS + c8 * 8], wj + (size_t)(n0 + row) * C + k0 + c8 * 8);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  __syncthreads();  // wsh/ush
  if (n_it > 0) {
    load_a(0);
    load_b(0, 0);
    cp_async_commit();
    store_a(0, 0);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int it = 0; it < n_it; ++it) {
    const int cur = it & 1;
    const bool next = it + 1 < n_it;
    if (next) {
      load_a(it + 1);
      load_b(it + 1, cur ^ 1);
      cp_async_commit();
    }
    const __nv_bfloat16* at_ = as[cur];
    const __nv_bfloat16* bt = bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                at_ + (wm * 32 + mt * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3,
                bt + (wn_ * 64 + np * 16 + (lane & 7) + (lane >> 4) * 8) * LDS + kk * 16 +
                    ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(acc[mt][2 * np], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
          mma16816(acc[mt][2 * np + 1], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b2, b3);
        }
      }
    }
    if (next) {
      store_a(it + 1, cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  // epilogue: + bias (+ residual) in fp32, store bf16; rows past S are not
  // stored; cs1/cs2 sum this thread's stored values per column
  float cs1[8][2], cs2[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) cs1[nt][0] = cs1[nt][1] = cs2[nt][0] = cs2[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int s = s0 + wm * 32 + mt * 16 + g + hr * 8;
      if (s >= S) continue;
      const size_t base = at(f, s, O);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn_ * 64 + nt * 8 + tig * 2;
        float v0 = acc[mt][nt][2 * hr] + bias[(size_t)b * O + col];
        float v1 = acc[mt][nt][2 * hr + 1] + bias[(size_t)b * O + col + 1];
        if (res != nullptr) {
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(res + base + col);
          v0 += __bfloat162float(r2.x);
          v1 += __bfloat162float(r2.y);
        }
        const __nv_bfloat162 o2 = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(y + base + col) = o2;
        const float2 r = __bfloat1622float2(o2);
        cs1[nt][0] += r.x;
        cs1[nt][1] += r.y;
        cs2[nt][0] = fmaf(r.x, r.x, cs2[nt][0]);
        cs2[nt][1] = fmaf(r.y, r.y, cs2[nt][1]);
      }
    }
  }
  if (part1 == nullptr) return;

  // lanes tig, tig + 4, ..., tig + 28 hold the same columns: sum over them
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs1[nt][e] += __shfl_xor_sync(0xffffffffu, cs1[nt][e], off);
        cs2[nt][e] += __shfl_xor_sync(0xffffffffu, cs2[nt][e], off);
      }
  // then over the four M-warps, through the A buffer (free after the loop's
  // last barrier): red[0 or 1][wm][column in the block]
  float* red = reinterpret_cast<float*>(&as[0][0]);
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = wn_ * 64 + nt * 8 + tig * 2 + e;
        red[wm * BN + col] = cs1[nt][e];
        red[(4 + wm) * BN + col] = cs2[nt][e];
      }
  }
  __syncthreads();
  if (tid < BN) {
    const float a1 = ((red[tid] + red[BN + tid]) + red[2 * BN + tid]) + red[3 * BN + tid];
    const float a2 = ((red[4 * BN + tid] + red[5 * BN + tid]) + red[6 * BN + tid]) + red[7 * BN + tid];
    const size_t p = (((size_t)b * F + f) * gridDim.x + blockIdx.x) * O + n0 + tid;
    part1[p] = a1;
    part2[p] = a2;
  }
}

// o[b, chunk, :] = sum of a[b, chunk*RED_ROWS : (chunk+1)*RED_ROWS, :] over
// the rows < `rows`, for a1 and a2 at once; a (B, rows, O), o (B, chunks, O).
// One block per (128 columns, chunk, b): 8 warps stride the chunk's rows,
// each lane 4 columns; the 8 warp sums are added in order.
__global__ void __launch_bounds__(256) colsum_kernel(
    const float* __restrict__ a1, const float* __restrict__ a2, float* __restrict__ o1,
    float* __restrict__ o2, int rows, int O) {
  __shared__ float4 r1[8][32], r2[8][32];
  const int lane = threadIdx.x & 31, wy = threadIdx.x >> 5;
  const int col = blockIdx.x * 128 + lane * 4;
  const int chunk = blockIdx.y, b = blockIdx.z;
  const int lo = chunk * RED_ROWS, hi = min(rows, lo + RED_ROWS);
  float4 t1 = make_float4(0.f, 0.f, 0.f, 0.f), t2 = t1;
  for (int r = lo + wy; r < hi; r += 8) {
    const size_t off = ((size_t)b * rows + r) * O + col;
    const float4 u = *reinterpret_cast<const float4*>(a1 + off);
    const float4 w = *reinterpret_cast<const float4*>(a2 + off);
    t1.x += u.x; t1.y += u.y; t1.z += u.z; t1.w += u.w;
    t2.x += w.x; t2.y += w.y; t2.z += w.z; t2.w += w.w;
  }
  r1[wy][lane] = t1;
  r2[wy][lane] = t2;
  __syncthreads();
  if (wy == 0) {
    for (int k = 1; k < 8; ++k) {
      const float4 u = r1[k][lane], w = r2[k][lane];
      t1.x += u.x; t1.y += u.y; t1.z += u.z; t1.w += u.w;
      t2.x += w.x; t2.y += w.y; t2.z += w.z; t2.w += w.w;
    }
    const size_t off = ((size_t)b * gridDim.y + chunk) * O + col;
    *reinterpret_cast<float4*>(o1 + off) = t1;
    *reinterpret_cast<float4*>(o2 + off) = t2;
  }
}

long long partial_rows(int F, int S) { return (long long)F * ((S + BM - 1) / BM); }

}  // namespace

// Floats of scratch that gn_silu_tconv_bf16 needs to emit statistics.
extern "C" long long gn_silu_tconv_workspace_floats(int B, int F, int S, int O) {
  const long long p = partial_rows(F, S);
  return 2LL * B * O * (p + (p + RED_ROWS - 1) / RED_ROWS);
}

// x (B,F,S,C); res and y (B,F,S,O); w, u (B,C) fp32, not read when silu is
// 0; wt (k,O,C) bf16; bias (B,O) fp32; res may be null. With a workspace ws
// of gn_silu_tconv_workspace_floats floats, s1 and s2 (B,O) fp32 receive the
// sums over (F, S) of y and y*y; ws null emits nothing. Requires C % 32 == 0,
// C <= 1024, O % 128 == 0, odd k <= 7, contiguous 16-byte aligned tensors.
// Returns cudaGetLastError().
extern "C" int gn_silu_tconv_bf16(const void* x, const void* w, const void* u, const void* wt,
                                  const void* bias, const void* res, void* y, int B, int F, int S,
                                  int C, int O, int K, int silu, void* ws, void* s1, void* s2,
                                  void* stream) {
  if (B < 1 || F < 1 || S < 1 || C % BK || C > MAX_C || O % BN || K % 2 == 0 || K > 7 ||
      (long long)B * F > 65535 || O / BN > 65535 || (ws != nullptr && (s1 == nullptr || s2 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long p = partial_rows(F, S), n_part = (long long)B * p * O;
  float* part1 = static_cast<float*>(ws);
  float* part2 = ws ? part1 + n_part : nullptr;
  dim3 grid((S + BM - 1) / BM, O / BN, B * F);
  const auto kernel = silu ? tconv_kernel<true> : tconv_kernel<false>;
  kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(y), part1, part2, F, S, C, O, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ws == nullptr) return (int)err;

  // sum the partials, RED_ROWS rows per block, until one row is left; the
  // passes alternate between the tail of ws and its head
  float* tail = part1 + 2 * n_part;
  const float *src1 = part1, *src2 = part2;
  long long rows = p;
  bool to_tail = true;
  while (true) {
    const long long chunks = (rows + RED_ROWS - 1) / RED_ROWS;
    if (chunks > 65535) return (int)cudaErrorInvalidValue;
    float *dst1, *dst2;
    if (chunks == 1) {
      dst1 = static_cast<float*>(s1);
      dst2 = static_cast<float*>(s2);
    } else {
      dst1 = to_tail ? tail : part1;
      dst2 = dst1 + (long long)B * chunks * O;
    }
    colsum_kernel<<<dim3(O / 128, (unsigned)chunks, B), 256, 0, st>>>(src1, src2, dst1, dst2,
                                                                      (int)rows, O);
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return (int)err;
    src1 = dst1;
    src2 = dst2;
    rows = chunks;
    to_tail = !to_tail;
  }
}
