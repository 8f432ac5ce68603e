// Hand-derived VJP of the fused (f, grad f, packed Hessian) op (K2) for Hopper.
//
// Replaces diffudf_tpu/ops/pallas_vgh_vjp.py::_vgh_bwd_kernel (wrappers
// _vgh_bwd, make_vgh_op): the gradient of sum(cot * (f | g | h6 | 0)) with
// respect to every W and b of a uniform-width sine SIREN, for the forward of
// K1 (csrc/vgh.cu), written flat in the ravel_pytree layout (per layer b
// then w).  The math is that of pallas_vgh_vjp.py:15-22: per hidden layer
//
//   z-bar  = d1 a-bar + d2 (sum_k J-bar_k Jz_k + sum_m H-bar_m Hz_m)
//            - w^2 d1 sum_m H-bar_m O_m
//   Jz-bar = d1 J-bar + d2 sum_m H-bar_m dO_m/dJz,   Hz-bar = d1 H-bar
//   W-bar += carry_in^T [z-bar; Jz-bar; Hz-bar],     b-bar += sum z-bar
//   carry-bar_in = [z-bar; Jz-bar; Hz-bar] W^T
//
// and the first layer's, with its direct dependence of J1 and H1 on W1.
//
// Design.  dudf::bwd::launch<10, 8> of siren_bwd.cuh: tiles of T = 8
// points (80 carry rows) through the forward recompute and the cotangent
// chain on the tensor cores in 3xTF32 (float32 accuracy), each layer's
// carry and m-bar written once; then W-bar = C^T M-bar as a split-K
// 3xTF32 product whose per-CTA partials are written once and added in a
// fixed order.  See siren_bwd.cuh.
//
// Bound.  At 8x256 it does 27.5 MFLOP a point against 76 bytes of input:
// on the tensor cores, three TF32 products each, 3 * flop / 495e12 s (1.667
// ms at 9,990 points; FP32 FMA at 67e12 would be 4.105 ms).  It moves about
// 4.4 GB a launch at 9,990 points (1.3 ms at 3.35 TB/s): the carries,
// products and m-bars, 0.72 GB each, written once and read once.
//
// Built by ops/vgh.py with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// into a shared library with a plain C interface, loaded with ctypes.

#include "siren_bwd.cuh"

namespace {
constexpr int kT = 8;   // points per tile
constexpr int kR = 10;  // carry rows per point
}  // namespace

extern "C" {

// Points per tile of K2.
int vgh_bwd_tile() { return kT; }

// K2 on `stream`: the gradient of sum(cot[:, :10] * (f | g | h6)), flat,
// into out; -> cudaGetLastError() (0 = ok).  x (n, 3); cot (n, 16) = (f-bar
// | g-bar | h6-bar | 0); w1 (3, h); b1 (h); wh (n_mm, h, h); bh (n_mm, h);
// wl (h); grid tile CTAs; n_split row runs of split_rows rows for W-bar;
// the workspaces as ops/kernel_io.py::backward_plan sizes them.
int vgh_bwd_launch(const float* x, const float* cot, int n, const float* w1, const float* b1,
                   const float* wh, const float* bh, int n_mm, const float* wl, float w0,
                   float ww, int h, int grid, int n_split, long long split_rows, float* frag,
                   float* ws_m, float* cbuf, float* mbar, float* small, float* wpart,
                   float* out, void* stream) {
  return dudf::bwd::launch<kR, kT>(x, cot, 16, n, w1, b1, wh, bh, n_mm, wl, w0, ww, h, grid,
                                   n_split, split_rows, frag, ws_m, cbuf, mbar, small, wpart,
                                   out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
