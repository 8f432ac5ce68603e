// Fused SIREN value + gradient (K3a) and its hand-derived VJP (K3b) for Hopper.
//
// K3a replaces diffudf_tpu/ops/pallas_vg.py::_vg_fwd_kernel (wrapper
// vg_pallas): per point x, f(x) and g = df/dx of a uniform-width sine SIREN
// by forward Taylor mode with the four-row carry [a; J0; J1; J2].  Output
// row n is (f | g | 4 zeros), 8 floats, as the Pallas kernel's.
// K3b replaces diffudf_tpu/ops/pallas_vg.py::_vg_bwd_kernel (wrapper
// _vg_bwd): the gradient of sum(cot * (f | g | 0)) with respect to every W
// and b, written flat in the ravel_pytree layout (per layer b then w).
//
// Design.  K3a is K1's design (csrc/vgh.cu) at four rows a point: one CTA
// takes T = 16 points with one thread per hidden column, keeps its column
// of the 64 carry rows in registers and stages the carry in 64 KB of
// shared memory for each product; weights stream from L2.  K3b is
// dudf::bwd::launch<4, 16> of siren_bwd.cuh: tiles of 16 points (64 carry
// rows) through the forward recompute and the cotangent chain on the
// tensor cores in 3xTF32 (float32 accuracy), each layer's carry and m-bar
// written once, then W-bar = C^T M-bar as a split-K 3xTF32 product whose
// per-CTA partials are added in a fixed order (see there).
//
// Bound.  At 8x256 K3a does about 3.67 MFLOP a point (7 hidden layers x 4
// rows x 2*256^2, plus the first layer and the head) against 44 bytes of
// input and output a point: the FP32 FMA rate bounds it, M * flop / 67e12 s
// on an H100 SXM.  K3b does about 11.0 MFLOP a point (the forward
// recompute, then W-bar and the carry's cotangent) against 44 bytes, on the
// tensor cores as three TF32 products each: 3 * M * flop / 495e12 s (1.334
// ms at 19,980 points; FP32 FMA would be 3.284 ms).  It moves about 3.6 GB
// a launch there (1.1 ms at 3.35 TB/s): carries, products and m-bars, 0.57
// GB each, written once and read once.
//
// Built by ops/vg.py with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// into a shared library with a plain C interface, loaded with ctypes.

#include "siren_bwd.cuh"
#include "siren_taylor.cuh"

namespace {

constexpr int kT = 16;             // points per CTA
constexpr int kR = 4;              // carry rows per point
constexpr int kRows = kR * kT;
constexpr int kMaxWarps = dudf::kMaxH / 32;

__global__ void __launch_bounds__(dudf::kMaxH, 1)
vg_fwd_kernel(const float* __restrict__ x, int n,
              const float* __restrict__ w1, const float* __restrict__ b1,
              const float* __restrict__ wh, const float* __restrict__ bh, int n_mm,
              const float* __restrict__ wl, const float* __restrict__ bl,
              float w0, float ww, int h, float* __restrict__ out) {
  extern __shared__ float4 carry4[];
  float* carry = reinterpret_cast<float*>(carry4);  // [kRows][h]
  __shared__ float xs[kT * 3];
  __shared__ float partial[kRows * kMaxWarps];

  const int j = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kT;
  for (int i = j; i < kT * 3; i += blockDim.x) {
    xs[i] = base + i / 3 < n ? x[base * 3 + i] : 0.0f;
  }
  __syncthreads();

  float acc[kRows];
  dudf::first_layer<kR, kT>(xs, w1[j], w1[h + j], w1[2 * h + j], b1[j], w0, acc);
  for (int l = 0; l < n_mm; ++l) {
    dudf::stage_rows<kRows>(carry, acc, h, j);
    __syncthreads();
    dudf::row_product<kRows>(acc, carry4, wh + static_cast<int64_t>(l) * h * h, h, j);
    __syncthreads();  // every thread is done reading this layer's carry
    dudf::activate<kR, kT>(acc, bh[static_cast<int64_t>(l) * h + j], ww);
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
    const int q = r / kT, t = r % kT;  // q: 0 = f, 1..3 = g
    const int64_t p = base + t;
    if (p < n) out[p * 8 + q] = q == 0 ? v + bl[0] : v;
  }
  for (int i = j; i < kT * 4; i += blockDim.x) {
    const int64_t p = base + i / 4;
    if (p < n) out[p * 8 + 4 + i % 4] = 0.0f;
  }
}

}  // namespace

extern "C" {

// Points per tile of K3b.
int vg_bwd_tile() { return kT; }

// K3a on `stream`; -> cudaGetLastError() (0 = ok).  x (n, 3); w1 (3, h);
// b1 (h); wh (n_mm, h, h); bh (n_mm, h); wl (h); bl (1); out (n, 8).
int vg_launch(const float* x, int n, const float* w1, const float* b1,
              const float* wh, const float* bh, int n_mm,
              const float* wl, const float* bl, float w0, float ww, int h,
              float* out, void* stream) {
  if (h % 32 != 0 || h > dudf::kMaxH || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const int smem = kRows * h * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      vg_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((static_cast<int64_t>(n) + kT - 1) / kT);
  vg_fwd_kernel<<<grid, h, smem, static_cast<cudaStream_t>(stream)>>>(
      x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h, out);
  return static_cast<int>(cudaGetLastError());
}

// K3b on `stream`: the gradient of sum(cot[:, :4] * (f | g)), flat, into
// out; -> cudaGetLastError().  cot (n, 8) = (f-bar | g-bar | 0); the other
// arguments as vgh_bwd_launch's (csrc/vgh_bwd.cu).
int vg_bwd_launch(const float* x, const float* cot, int n, const float* w1, const float* b1,
                  const float* wh, const float* bh, int n_mm, const float* wl, float w0,
                  float ww, int h, int grid, int n_split, long long split_rows, float* frag,
                  float* ws_m, float* cbuf, float* mbar, float* small, float* wpart,
                  float* out, void* stream) {
  return dudf::bwd::launch<kR, kT>(x, cot, 8, n, w1, b1, wh, bh, n_mm, wl, w0, ww, h, grid,
                                   n_split, split_rows, frag, ws_m, cbuf, mbar, small, wpart,
                                   out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
