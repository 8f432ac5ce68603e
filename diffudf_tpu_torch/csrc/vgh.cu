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
// Design.  dudf::fwd::launch<10, 8, Product::kFp32> of siren_fwd.cuh: a
// persistent grid walks tiles of T = 8 points (80 carry rows); each thread
// holds 10 rows by 8 columns of the product and sums every element in FP32
// FMA over k in turn, the order of the plain version's float32 product,
// with W's rows from L2 through a shared ring.
//
// Bound.  About 9.18 MFLOP a point at 8x256 (7 hidden layers x 10 rows x
// 2*256^2, plus the first layer and the head) against 76 bytes of input and
// output: FP32 FMA at 67e12 flop/s, 1.369 ms at 9,990 points.
//
// Built by ops/vgh.py with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// into a shared library with a plain C interface, loaded with ctypes.

#include "siren_fwd.cuh"

namespace {
constexpr int kT = 8;   // points per tile
constexpr int kR = 10;  // carry rows per point
}  // namespace

extern "C" {

// Largest hidden width the kernel takes (one thread per column).
int vgh_max_width() { return dudf::kMaxH; }

// Points per tile of K1.
int vgh_tile() { return kT; }

// Launches K1 on `stream` and returns cudaGetLastError() (0 = ok).
// x (n, 3); w1 (3, h); b1 (h); wh (n_mm, h, h); bh (n_mm, h); wl (h);
// bl (1); grid tile CTAs; frag unused (FwdPlan sizes no workspace for K1);
// out (n, 16); all float32, contiguous, on the same device.  h must be a
// multiple of 32 and at most vgh_max_width().
int vgh_launch(const float* x, int n, const float* w1, const float* b1,
               const float* wh, const float* bh, int n_mm,
               const float* wl, const float* bl, float w0, float ww, int h,
               int grid, float* frag, float* out, void* stream) {
  return dudf::fwd::launch<kR, kT, dudf::fwd::Product::kFp32>(
      x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h, grid, frag, out, 16,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
