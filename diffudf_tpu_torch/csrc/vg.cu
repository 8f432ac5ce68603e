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
// Design.  K3a is dudf::fwd::launch<4, 16, Product::kTf32x3> of
// siren_fwd.cuh, K1's tile design (csrc/vgh.cu) at four rows a point with
// tensor-core products: a persistent grid walks tiles of
// T = 16 points (64 carry rows), whose products run on the tensor cores in
// 3xTF32 (float32 accuracy) with W's fragments from L2.  K3b is
// dudf::bwd::launch<4, 16> of siren_bwd.cuh: the same tiles through the
// forward recompute and the cotangent chain on the tensor cores in 3xTF32,
// each layer's carry and m-bar written once, then W-bar = C^T M-bar as a
// split-K 3xTF32 product whose per-CTA partials are added in a fixed order
// (see there).
//
// Bound.  At 8x256 K3a does about 3.67 MFLOP a point (7 hidden layers x 4
// rows x 2*256^2, plus the first layer and the head) against 44 bytes of
// input and output a point: as three TF32 products on the tensor cores,
// 3 * M * flop / 495e12 s (0.445 ms at 19,980 points; FP32 FMA at 67e12
// would be 1.096 ms).  K3b does about 11.0 MFLOP a point (the forward
// recompute, then W-bar and the carry's cotangent) against 44 bytes, on the
// tensor cores as three TF32 products each: 3 * M * flop / 495e12 s (1.334
// ms at 19,980 points; FP32 FMA would be 3.284 ms).  It moves about 3.6 GB
// a launch there (1.1 ms at 3.35 TB/s): carries, products and m-bars, 0.57
// GB each, written once and read once.
//
// Built by ops/vg.py with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// into a shared library with a plain C interface, loaded with ctypes.

#include "siren_bwd.cuh"
#include "siren_fwd.cuh"

namespace {
constexpr int kT = 16;  // points per tile, of K3a and of K3b
constexpr int kR = 4;   // carry rows per point
}  // namespace

extern "C" {

// Points per tile of K3a and K3b.
int vg_tile() { return kT; }

// K3a on `stream`; -> cudaGetLastError() (0 = ok).  x (n, 3); w1 (3, h);
// b1 (h); wh (n_mm, h, h); bh (n_mm, h); wl (h); bl (1); grid tile CTAs;
// frag n_mm h^2 floats of workspace; out (n, 8); as ops/kernel_io.py::
// FwdPlan sizes them.
int vg_launch(const float* x, int n, const float* w1, const float* b1,
              const float* wh, const float* bh, int n_mm,
              const float* wl, const float* bl, float w0, float ww, int h,
              int grid, float* frag, float* out, void* stream) {
  return dudf::fwd::launch<kR, kT, dudf::fwd::Product::kTf32x3>(
      x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h, grid, frag, out, 8,
      static_cast<cudaStream_t>(stream));
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
