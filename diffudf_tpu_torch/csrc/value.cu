// SIREN value f(x) for the sphere-trace march (K4) on Hopper.
//
// Replaces diffudf_tpu/ops/pallas_value.py::_value_kernel (wrapper
// value_pallas).  For each point x it computes f(x) of a uniform-width sine
// SIREN, nothing else:
//
//   a = sin(w0 (x W1 + b1));   a = sin(ww (a W_l + b_l)) per hidden product;
//   f = a W_last + b_last.
//
// Two modes, as compute_dtype in the JAX kernel.  f32: every operand float32.
// Mixed (bf16): the first layer, the biases, the sums and the sin stay
// float32; the hidden and head products take bf16 operands, i.e. each
// activation is rounded to bf16 (__float2bfloat16_rn) where it is staged
// and the weights arrive in bf16 from the wrapper.  The products of two bf16
// values are exact in float32, so the mode computes the same function as
// the plain version value_reference (ops/value.py) up to the order of the
// sums.  The sin is the shared polynomial of sincos.cuh (fast_sincos).
//
// Design: K1's (csrc/vgh.cu) at one carry row a point.  One CTA takes T = 64
// points; thread j owns hidden column j (blockDim = h, a multiple of 32, at
// most 256) and keeps its column of the T activations in registers.  Each
// layer stages the (T, h) activations in dynamic shared memory (64 KB at
// h = 256, set with cudaFuncSetAttribute), because the product needs every
// column; each thread then reads one weight W[k][j] per k straight from
// global memory (coalesced over j; the 8x256 net's weights, 1.8 MB in f32
// and 0.9 MB in bf16, stay in the 50 MB L2) and the activations as float4
// broadcasts from shared memory, four FP32 FMAs per shared load.  CUDA
// cores only: no TF32, no tensor cores (mma.sync or wgmma on bf16 operands
// is later work).  The head (width h -> 1) is a block reduction: warp
// shuffles, then one pass over the per-warp partial sums.  The ragged last
// tile is masked here; the caller pads nothing.
//
// Bound.  At 8x256 a point costs about 0.92 MFLOP (7 hidden products of
// 2*256^2, the first layer 2*3*256 and the head 2*256) against 16 bytes in
// and out, so operations bound it: the f32 mode at the FP32 FMA rate of 67
// TFLOP/s takes at least 3.6 ms for 262,144 points (7.1 ms for 519,168);
// the bf16 mode's bound at the dense bf16 tensor rate of 989 TFLOP/s is
// about 0.24 ms (0.49 ms) and this kernel, on CUDA cores, sits far from it.
//
// Built by ops/value.py with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// into a shared library with a plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sincos.cuh"

namespace {

constexpr int kT = 64;         // points per CTA
constexpr int kMaxH = 256;     // threads per CTA = hidden width
constexpr int kMaxWarps = kMaxH / 32;

__device__ __forceinline__ float load_w(const float* p) { return *p; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// An activation as the product reads it: itself, or rounded to bf16.
template <bool kMixed>
__device__ __forceinline__ float operand(float a) {
  if constexpr (kMixed) return __bfloat162float(__float2bfloat16_rn(a));
  return a;
}

template <bool kMixed, typename WT>
__global__ void __launch_bounds__(kMaxH, 2)
value_kernel(const float* __restrict__ x, int n,
             const float* __restrict__ w1, const float* __restrict__ b1,
             const WT* __restrict__ wh, const float* __restrict__ bh, int n_hidden_mm,
             const WT* __restrict__ wl, const float* __restrict__ bl,
             float w0, float ww, int h, float* __restrict__ out) {
  extern __shared__ float4 act4[];
  float* act = reinterpret_cast<float*>(act4);  // [kT][h], row-major
  __shared__ float xs[kT * 3];
  __shared__ float partial[kT * kMaxWarps];

  const int j = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kT;

  for (int i = j; i < kT * 3; i += blockDim.x) {
    const int64_t p = base + i / 3;
    xs[i] = p < n ? x[base * 3 + i] : 0.0f;
  }
  __syncthreads();

  float acc[kT];

  // First layer, always float32: z = x W1 + b1, a = sin(w0 z).
  {
    const float wa = w1[j], wb = w1[h + j], wc = w1[2 * h + j];
    const float bj = b1[j];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const float z = xs[3 * t] * wa + xs[3 * t + 1] * wb + xs[3 * t + 2] * wc + bj;
      acc[t] = dudf::fast_sin(w0 * z);
    }
  }

  for (int l = 0; l < n_hidden_mm; ++l) {
#pragma unroll
    for (int t = 0; t < kT; ++t) act[t * h + j] = operand<kMixed>(acc[t]);
    __syncthreads();

    const WT* W = wh + static_cast<int64_t>(l) * h * h;
#pragma unroll
    for (int t = 0; t < kT; ++t) acc[t] = 0.0f;
    for (int k = 0; k < h; k += 4) {
      const float wk0 = load_w(W + (k + 0) * h + j);
      const float wk1 = load_w(W + (k + 1) * h + j);
      const float wk2 = load_w(W + (k + 2) * h + j);
      const float wk3 = load_w(W + (k + 3) * h + j);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const float4 c = act4[(t * h + k) >> 2];
        acc[t] = fmaf(c.x, wk0, acc[t]);
        acc[t] = fmaf(c.y, wk1, acc[t]);
        acc[t] = fmaf(c.z, wk2, acc[t]);
        acc[t] = fmaf(c.w, wk3, acc[t]);
      }
    }
    __syncthreads();  // every thread is done reading this layer's activations

    const float bj = bh[static_cast<int64_t>(l) * h + j];
#pragma unroll
    for (int t = 0; t < kT; ++t) acc[t] = dudf::fast_sin(ww * (acc[t] + bj));
  }

  // Head: each point's activations dotted with wl, summed over the block.
  const float wlj = load_w(wl + j);
  const int lane = j & 31, warp = j >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    float v = operand<kMixed>(acc[t]) * wlj;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) partial[t * kMaxWarps + warp] = v;
  }
  __syncthreads();
  for (int t = j; t < kT; t += blockDim.x) {
    float v = 0.0f;
    for (int w = 0; w < n_warps; ++w) v += partial[t * kMaxWarps + w];
    const int64_t p = base + t;
    if (p < n) out[p] = v + bl[0];
  }
}

template <bool kMixed, typename WT>
int launch(const float* x, int n, const float* w1, const float* b1, const void* wh,
           const float* bh, int n_hidden_mm, const void* wl, const float* bl, float w0,
           float ww, int h, float* out, cudaStream_t stream) {
  const int smem = kT * h * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      value_kernel<kMixed, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((static_cast<int64_t>(n) + kT - 1) / kT);
  value_kernel<kMixed, WT><<<grid, h, smem, stream>>>(
      x, n, w1, b1, static_cast<const WT*>(wh), bh, n_hidden_mm,
      static_cast<const WT*>(wl), bl, w0, ww, h, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// x (n, 3); w1 (3, h); b1 (h); wh (n_hidden_mm, h, h); bh (n_hidden_mm, h);
// wl (h); bl (1); out (n); contiguous, on the same device.  wh and wl are
// bfloat16 when mixed is nonzero, float32 otherwise; everything else is
// float32.  h must be a multiple of 32 and at most 256.
int value_launch(const float* x, int n, const float* w1, const float* b1, const void* wh,
                 const float* bh, int n_hidden_mm, const void* wl, const float* bl,
                 float w0, float ww, int h, int mixed, float* out, void* stream) {
  if (h % 32 != 0 || h > kMaxH || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mixed)
    return launch<true, __nv_bfloat16>(x, n, w1, b1, wh, bh, n_hidden_mm, wl, bl, w0, ww, h,
                                       out, s);
  return launch<false, float>(x, n, w1, b1, wh, bh, n_hidden_mm, wl, bl, w0, ww, h, out, s);
}

}  // extern "C"
