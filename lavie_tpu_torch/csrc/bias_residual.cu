// The residual add that ends a ResnetBlock3D or a TemporalModule3D, with the
// biases of the convolutions that feed it folded in, over (rows, C), channels
// last, bf16:
//   out = bf16(bf16(x + b_x) + bf16(h + b_h))
// x is the block input or the bias-free output of the shortcut convolution,
// h the bias-free output of conv2 (of the temporal module's shift conv), b_x
// and b_h per-channel biases in fp32 or bf16 (the parameters as they are, so
// that no conversion runs a launch of its own), each optional: absent, its
// add and its rounding drop out. Each add is the fp32 sum of its two
// operands rounded once to bf16, which is PyTorch's bf16 add, in the order of
// the ops it replaces (cuDNN's convolution, ATen's add_ of its bias, then
// x + h): given the same convolution outputs, out is theirs bit for bit.
//
// Replaces no Pallas kernel: the JAX package leaves the convolutions' biases
// and the residual add to XLA (lavie_tpu/nn/resnet.py, ResnetBlock3D;
// lavie_tpu/nn/temporal_module.py). It replaces, on the port's cuDNN route,
// ATen's add_ of a (1, C, 1, 1) bias onto each convolution's channels-last
// output (a broadcast for which no operand is contiguous, so PyTorch's
// non-vectorised elementwise_kernel: a read and a write of the output, 4
// bytes an element, twice in a block with a shortcut), and the vectorised
// x + h after them.
//
// What bounds it on the H100: bytes. x and h are read once and out written
// once, 6 bytes an element; the VSR UNet's largest call (8 x 163840 x 512)
// moves 4.03 GB, 1.20 ms at 3.35 TB/s. One or three fp32 adds an element are
// far below the card's rates.
//
// What the design does about it: group_norm.cu's gn_apply_kernel's shape. A
// grid of blocks over whole rows, 256 threads, 16 bytes of x, of h and of out
// a thread a step, four steps in flight; the biases in shared memory in fp32;
// a template instance for each pair of present biases, so that no branch
// sits in the loop.

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHANNELS = 4096;  // two fp32 bias rows in 32 KB of shared memory
constexpr int FLAG_BX_BF16 = 1, FLAG_BH_BF16 = 2;

__device__ __forceinline__ float load_f(const void* p, int i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// bf16(a + b) for the two channels packed in a, b0 and b1 in fp32: the sum
// in fp32, rounded once
__device__ __forceinline__ uint32_t add2(uint32_t a, float b0, float b1) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const __nv_bfloat162 r = __floats2bfloat162_rn(__fadd_rn(f.x, b0), __fadd_rn(f.y, b1));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf16(a + b) for two packed pairs
__device__ __forceinline__ uint32_t sum2(uint32_t a, uint32_t b) {
  const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return add2(a, g.x, g.y);
}

// the two channels 2q, 2q + 1 of a vector: bf16(bf16(x + bx) + bf16(h + bh))
template <bool BX, bool BH>
__device__ __forceinline__ uint32_t residual2(uint32_t x, uint32_t h, const float* bx,
                                              const float* bh, int q) {
  if (BX) x = add2(x, bx[2 * q], bx[2 * q + 1]);
  if (BH) h = add2(h, bh[2 * q], bh[2 * q + 1]);
  return sum2(x, h);
}

// 8 channels (16 bytes of x and h), vector cv of a row; the biases from
// shared memory
template <bool BX, bool BH>
__device__ __forceinline__ uint4 residual8(uint4 x, uint4 h, const float4* bxs, const float4* bhs,
                                           int cv) {
  float bx[8], bh[8];
  if (BX) {
    *reinterpret_cast<float4*>(bx) = bxs[2 * cv];
    *reinterpret_cast<float4*>(bx + 4) = bxs[2 * cv + 1];
  }
  if (BH) {
    *reinterpret_cast<float4*>(bh) = bhs[2 * cv];
    *reinterpret_cast<float4*>(bh + 4) = bhs[2 * cv + 1];
  }
  x.x = residual2<BX, BH>(x.x, h.x, bx, bh, 0);
  x.y = residual2<BX, BH>(x.y, h.y, bx, bh, 1);
  x.z = residual2<BX, BH>(x.z, h.z, bx, bh, 2);
  x.w = residual2<BX, BH>(x.w, h.w, bx, bh, 3);
  return x;
}

// the channel vector `adv` vectors on, for adv < cvs
__device__ __forceinline__ int advance(int cv, int adv, int cvs) {
  cv += adv;
  return cv >= cvs ? cv - cvs : cv;
}

// out = the residual of x and h over the 16-byte vectors [blockIdx.x * chunk,
// ...), whole rows; dynamic shared memory: the present biases' fp32 rows
template <bool BX, bool BH>
__global__ void __launch_bounds__(THREADS) bias_residual_kernel(
    const uint4* __restrict__ x, const uint4* __restrict__ h, const void* __restrict__ bx,
    const void* __restrict__ bh, uint4* __restrict__ out, long long total, long long chunk, int C,
    int flags) {
  extern __shared__ float4 bias[];  // C floats of b_x when present, then C of b_h
  float* bxf = reinterpret_cast<float*>(bias);
  float* bhf = bxf + (BX ? C : 0);
  for (int i = threadIdx.x; i < C; i += THREADS) {
    if (BX) bxf[i] = load_f(bx, i, flags & FLAG_BX_BF16);
    if (BH) bhf[i] = load_f(bh, i, flags & FLAG_BH_BF16);
  }
  __syncthreads();
  const float4* bxs = reinterpret_cast<const float4*>(bxf);
  const float4* bhs = reinterpret_cast<const float4*>(bhf);
  const int cvs = C / 8;
  const long long lo = blockIdx.x * chunk;  // a multiple of cvs: the block starts at channel 0
  const int len = (int)min(chunk, total - lo);  // vectors of this block, under 2^31
  const uint4* xs = x + lo;
  const uint4* hs = h + lo;
  uint4* os = out + lo;
  const int adv = THREADS % cvs;  // the channel vector's step a step
  constexpr int S = THREADS;
  int i = threadIdx.x, cv = i % cvs;
  for (; i + 3 * S < len; i += 4 * S) {
    const int c1 = advance(cv, adv, cvs), c2 = advance(c1, adv, cvs), c3 = advance(c2, adv, cvs);
    const uint4 x0 = xs[i], x1 = xs[i + S], x2 = xs[i + 2 * S], x3 = xs[i + 3 * S];
    const uint4 h0 = hs[i], h1 = hs[i + S], h2 = hs[i + 2 * S], h3 = hs[i + 3 * S];
    os[i] = residual8<BX, BH>(x0, h0, bxs, bhs, cv);
    os[i + S] = residual8<BX, BH>(x1, h1, bxs, bhs, c1);
    os[i + 2 * S] = residual8<BX, BH>(x2, h2, bxs, bhs, c2);
    os[i + 3 * S] = residual8<BX, BH>(x3, h3, bxs, bhs, c3);
    cv = advance(c3, adv, cvs);
  }
  for (; i < len; i += S) {
    os[i] = residual8<BX, BH>(xs[i], hs[i], bxs, bhs, cv);
    cv = advance(cv, adv, cvs);
  }
}

template <bool BX, bool BH>
void launch(int grid, size_t smem, cudaStream_t st, const void* x, const void* h, const void* bx,
            const void* bh, void* out, long long total, long long chunk, int C, int flags) {
  bias_residual_kernel<BX, BH><<<grid, THREADS, smem, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(h), bx, bh, static_cast<uint4*>(out),
      total, chunk, C, flags);
}

}  // namespace

// out = bf16(bf16(x + b_x) + bf16(h + b_h)) over x, h, out (rows, C) bf16,
// contiguous; b_x, b_h (C) or null (no add), fp32 unless flags say bf16 (1:
// b_x, 2: b_h). blocks: the grid's size aimed at
// (kernels/bias_residual.py::launch_plan); each block takes whole rows.
extern "C" int bias_residual_bf16(const void* x, const void* h, const void* bx, const void* bh,
                                  void* out, int rows, int C, int blocks, int flags,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(out);
  if (rows < 1 || C < 8 || C % 8 || C > MAX_CHANNELS || blocks < 1 || align % 16)
    return (int)cudaErrorInvalidValue;
  const int cvs = C / 8;
  const int rows_per_block = (rows + blocks - 1) / blocks;
  const long long chunk = (long long)rows_per_block * cvs;
  if (chunk >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)rows * cvs;
  const int grid = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)((bx != nullptr) + (bh != nullptr)) * C * sizeof(float);
  if (bx && bh)
    launch<true, true>(grid, smem, st, x, h, bx, bh, out, total, chunk, C, flags);
  else if (bx)
    launch<true, false>(grid, smem, st, x, h, bx, bh, out, total, chunk, C, flags);
  else if (bh)
    launch<false, true>(grid, smem, st, x, h, bx, bh, out, total, chunk, C, flags);
  else
    launch<false, false>(grid, smem, st, x, h, bx, bh, out, total, chunk, C, flags);
  return (int)cudaGetLastError();
}
