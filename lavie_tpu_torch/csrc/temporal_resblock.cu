// Fused GroupNorm-apply -> SiLU -> k-tap frame-axis convolution of the VSR
// ResnetBlock3DCNN, with the conv bias (time embedding folded in) and the
// block residual in the fp32 accumulator:
//   y[b,f,s,o] = bias[b,o] + sum_j sum_c act[b,f+j-k/2,s,c] W[j,o,c] (+ res[b,f,s,o])
//   act = bf16(silu_fp32(bf16(bf16(x * bf16(w[b,c])) + bf16(u[b,c]))))
// Frames outside [0, F) contribute nothing (zero padding of the activated
// input). x, W, res, y bf16; w, u, bias fp32.
//
// Replaces: lavie_tpu/kernels/temporal_resblock.py
//   gn_silu_tconv     (_conv_4d, body _kernel)      frame-major (B, F, S, C)
//   gn_silu_tconv_sfc (_conv_sfc, body _kernel_sfc) token-major (B, S, F, C)
// The port keeps video frame-major at both call sites, so this kernel takes
// that layout only (XLA's conv layout is what made the token-major form).
//
// What bounds it on the H100: tensor-core operations. At the VSR L0 level
// (S = 163840, C = O = 256, F = 8, k = 5) the taps that land inside the
// window are 34 of 40, 2*34*S*C*O = 0.73 TFLOP, ~0.74 ms at 989 TFLOP/s,
// against 2*2*F*S*C bytes (1.3 GB, 0.40 ms at 3.35 TB/s). The unfused chain
// would also write and read back the normalised and activated tensors.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // shared row stride (elements)
constexpr int THREADS = 256;
constexpr int MAX_C = 1024;

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

__global__ void __launch_bounds__(THREADS) tconv_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ wn,
    const float* __restrict__ un, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ y, int F, int S, int C, int O, int K) {
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

  for (int c = tid; c < C; c += THREADS) {
    wsh[c] = __float2bfloat16(wn[(size_t)b * C + c]);
    ush[c] = __float2bfloat16(un[(size_t)b * C + c]);
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
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = k0 + c8 * 8 + e;
        const float t = __bfloat162float(__hadd(__hmul(v[e], wsh[c]), ush[c]));
        v[e] = __float2bfloat16(t / (1.f + expf(-t)));
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

  // epilogue: + bias (+ residual) in fp32, store bf16; rows past S are not stored
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
        *reinterpret_cast<__nv_bfloat162*>(y + base + col) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

}  // namespace

// x (B,F,S,C); res and y (B,F,S,O); w, u (B,C) fp32; wt (k,O,C) bf16;
// bias (B,O) fp32; res may be null. Requires C % 32 == 0, C <= 1024, O % 128 == 0, odd k <= 7,
// contiguous 16-byte aligned tensors. Returns cudaGetLastError().
extern "C" int gn_silu_tconv_bf16(const void* x, const void* w, const void* u, const void* wt,
                                  const void* bias, const void* res, void* y, int B, int F, int S,
                                  int C, int O, int K, void* stream) {
  if (B < 1 || F < 1 || S < 1 || C % BK || C > MAX_C || O % BN || K % 2 == 0 || K > 7 ||
      (long long)B * F > 65535 || O / BN > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((S + BM - 1) / BM, O / BN, B * F);
  tconv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(y), F, S, C, O, K);
  return (int)cudaGetLastError();
}
