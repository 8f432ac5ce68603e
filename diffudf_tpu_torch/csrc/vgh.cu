// Fused SIREN value + gradient + packed Hessian (K1) for Hopper.
//
// Replaces diffudf_tpu/ops/pallas_vgh.py::_vgh_kernel (wrapper vgh_pallas).
// For each point x it computes f(x), the gradient g = df/dx and the six
// upper-triangle Hessian entries h6 = (xx, xy, xz, yy, yz, zz) of a
// uniform-width sine SIREN by forward Taylor mode: per point the carry is
// ten rows [a; J0..J2; H0..H5] of width h, and every hidden layer maps the
// whole carry through one matrix product followed by elementwise work
//
//   z = m_a + b,  s, c = sincos(ww z),  d1 = ww c,  d2 = -ww^2 s
//   a' = s,  J'_k = d1 m_Jk,  H'_(ij) = d1 m_H(ij) + d2 m_Ji m_Jj.
//
// Output row n is (f | g | h6 | 6 zeros), 16 floats, as the Pallas kernel's.
//
// Design.  One CTA takes T = 8 points; thread j owns hidden column j, so
// blockDim = h.  The thread keeps its column of the 10*T carry rows in
// registers (acc[]), which is all the elementwise update needs; the whole
// carry is also staged in dynamic shared memory (10*T*h floats = 80 KB at
// h = 256, set with cudaFuncSetAttribute), because the product needs every
// column of it.  In the product
// each thread reads one weight W[k][j] per k straight from global memory
// (coalesced over j; the 8x256 net's 1.8 MB of weights stay in the 50 MB
// L2) and the carry as float4 broadcasts from shared memory, four FP32 FMAs
// per shared load.  FP32 FMA throughout: no TF32, no tensor cores.  The
// ragged last tile is masked here rather than padded by the caller.  The
// output head (width h -> 1) is a block reduction: warp shuffles, then one
// pass over the per-warp partial sums.
//
// Bound.  The work is about 9.18 MFLOP per point at 8x256 (7 hidden layers x
// 10 rows x 2*256^2, plus the first layer and the head) against 64 bytes of
// output and 12 of input, so the FP32 FMA rate bounds it: M points take at
// least M * 9.18e6 / 67e12 s on an H100 SXM at its full power limit.
//
// Built by ops/vgh.py with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// into a shared library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sincos.cuh"

namespace {

constexpr int kT = 8;              // points per CTA
constexpr int kRows = 10 * kT;     // carry rows per CTA
constexpr int kMaxH = 256;         // threads per CTA = hidden width
constexpr int kMaxWarps = kMaxH / 32;

// One CTA per SM: the 80 accumulators take ~234 registers a thread; capping
// them at 128 so that two CTAs fit made ptxas spill, and ran slower.
__global__ void __launch_bounds__(kMaxH, 1)
vgh_kernel(const float* __restrict__ x, int n,
           const float* __restrict__ w1, const float* __restrict__ b1,
           const float* __restrict__ wh, const float* __restrict__ bh,
           int n_hidden_mm,
           const float* __restrict__ wl, const float* __restrict__ bl,
           float w0, float ww, int h, float* __restrict__ out) {
  extern __shared__ float4 carry4[];
  float* carry = reinterpret_cast<float*>(carry4);  // [kRows][h], row-major
  __shared__ float xs[kT * 3];
  __shared__ float partial[kRows * kMaxWarps];

  const int j = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kT;

  for (int i = j; i < kT * 3; i += blockDim.x) {
    const int64_t p = base + i / 3;
    xs[i] = p < n ? x[base * 3 + i] : 0.0f;
  }
  __syncthreads();

  float acc[kRows];

  // First layer: z = x W1 + b1, and the carry it starts.
  {
    const float wa = w1[j], wb = w1[h + j], wc = w1[2 * h + j];
    const float bj = b1[j];
    const float w0sq = w0 * w0;
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      const float z = xs[3 * t] * wa + xs[3 * t + 1] * wb + xs[3 * t + 2] * wc + bj;
      float s, c;
      dudf::fast_sincos(w0 * z, &s, &c);
      const float d1 = w0 * c;
      const float d2 = -w0sq * s;
      acc[t] = s;
      acc[1 * kT + t] = d1 * wa;
      acc[2 * kT + t] = d1 * wb;
      acc[3 * kT + t] = d1 * wc;
      acc[4 * kT + t] = d2 * (wa * wa);
      acc[5 * kT + t] = d2 * (wa * wb);
      acc[6 * kT + t] = d2 * (wa * wc);
      acc[7 * kT + t] = d2 * (wb * wb);
      acc[8 * kT + t] = d2 * (wb * wc);
      acc[9 * kT + t] = d2 * (wc * wc);
    }
  }

  const float wwsq = ww * ww;
  for (int l = 0; l < n_hidden_mm; ++l) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) carry[r * h + j] = acc[r];
    __syncthreads();

    const float* W = wh + static_cast<int64_t>(l) * h * h;
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    for (int k = 0; k < h; k += 4) {
      const float wk0 = W[(k + 0) * h + j];
      const float wk1 = W[(k + 1) * h + j];
      const float wk2 = W[(k + 2) * h + j];
      const float wk3 = W[(k + 3) * h + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 c = carry4[(r * h + k) >> 2];
        acc[r] = fmaf(c.x, wk0, acc[r]);
        acc[r] = fmaf(c.y, wk1, acc[r]);
        acc[r] = fmaf(c.z, wk2, acc[r]);
        acc[r] = fmaf(c.w, wk3, acc[r]);
      }
    }
    __syncthreads();  // every thread is done reading this layer's carry

    const float bj = bh[static_cast<int64_t>(l) * h + j];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      float s, c;
      dudf::fast_sincos(ww * (acc[t] + bj), &s, &c);
      const float d1 = ww * c;
      const float d2 = -wwsq * s;
      const float j0 = acc[1 * kT + t], j1 = acc[2 * kT + t], j2 = acc[3 * kT + t];
      acc[t] = s;
      acc[1 * kT + t] = d1 * j0;
      acc[2 * kT + t] = d1 * j1;
      acc[3 * kT + t] = d1 * j2;
      acc[4 * kT + t] = d1 * acc[4 * kT + t] + d2 * (j0 * j0);
      acc[5 * kT + t] = d1 * acc[5 * kT + t] + d2 * (j0 * j1);
      acc[6 * kT + t] = d1 * acc[6 * kT + t] + d2 * (j0 * j2);
      acc[7 * kT + t] = d1 * acc[7 * kT + t] + d2 * (j1 * j1);
      acc[8 * kT + t] = d1 * acc[8 * kT + t] + d2 * (j1 * j2);
      acc[9 * kT + t] = d1 * acc[9 * kT + t] + d2 * (j2 * j2);
    }
  }

  // Output head: row r of the carry dotted with wl, summed over the block.
  const float wlj = wl[j];
  const int lane = j & 31, warp = j >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float v = acc[r] * wlj;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) partial[r * kMaxWarps + warp] = v;
  }
  __syncthreads();
  for (int r = j; r < kRows; r += blockDim.x) {
    float v = 0.0f;
    for (int w = 0; w < n_warps; ++w) v += partial[r * kMaxWarps + w];
    const int q = r / kT, t = r % kT;  // q: 0 = f, 1..3 = g, 4..9 = h6
    const int64_t p = base + t;
    if (p < n) out[p * 16 + q] = q == 0 ? v + bl[0] : v;
  }
  for (int i = j; i < kT * 6; i += blockDim.x) {
    const int64_t p = base + i / 6;
    if (p < n) out[p * 16 + 10 + i % 6] = 0.0f;
  }
}

}  // namespace

extern "C" {

// Largest hidden width the kernel takes (one thread per column).
int vgh_max_width() { return kMaxH; }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// x (n, 3); w1 (3, h); b1 (h); wh (n_hidden_mm, h, h); bh (n_hidden_mm, h);
// wl (h); bl (1); out (n, 16); all float32, contiguous, on the same device.
// h must be a multiple of 32 and at most vgh_max_width().
int vgh_launch(const float* x, int n, const float* w1, const float* b1,
               const float* wh, const float* bh, int n_hidden_mm,
               const float* wl, const float* bl, float w0, float ww, int h,
               float* out, void* stream) {
  if (h % 32 != 0 || h > kMaxH || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int smem = kRows * h * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      vgh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((static_cast<int64_t>(n) + kT - 1) / kT);
  vgh_kernel<<<grid, h, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, w1, b1, wh, bh, n_hidden_mm, wl, bl, w0, ww, h, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
