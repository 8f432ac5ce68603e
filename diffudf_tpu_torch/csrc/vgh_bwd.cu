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
// Design.  siren_bwd_kernel<10, 8> of siren_taylor.cuh: T = 8 points a CTA,
// one thread per hidden column, the 80 carry rows of a tile in registers;
// a persistent grid of at most one CTA per SM, each with its own workspace
// (the carries and products of the forward recompute, 1.1 MB at 8x256) and
// its own partial sums of the gradient; a second kernel adds the partials
// in a fixed order.  See siren_taylor.cuh for why.
//
// Bound.  At 8x256 it does about 27.5 MFLOP a point (the forward recompute,
// 9.18, then W-bar and the carry's cotangent, two 10-row products a layer)
// against 76 bytes of input a point: the FP32 FMA rate bounds it, M * flop /
// 67e12 s on an H100 SXM.
//
// Built by ops/vgh.py with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// into a shared library with a plain C interface, loaded with ctypes.

#include "siren_taylor.cuh"

namespace {
constexpr int kT = 8;   // points per CTA
constexpr int kR = 10;  // carry rows per point
}  // namespace

extern "C" {

// Points per CTA of K2.
int vgh_bwd_tile() { return kT; }

// K2 on `stream`, then the reduction of its per-CTA partial sums;
// -> cudaGetLastError() (0 = ok).  x (n, 3); cot (n, 16) = (f-bar | g-bar |
// h6-bar | 0); w1 (3, h); b1 (h); wh (n_mm, h, h) and wht, its transpose per
// layer; bh (n_mm, h); wl (h); grid <= ceil(n / vgh_bwd_tile()) CTAs;
// ws_carry and ws_m hold grid * n_mm * 80 * h floats each, partial grid * P
// and out P, P = 4h + n_mm (h + h^2) + 1 + h, the flat gradient.
int vgh_bwd_launch(const float* x, const float* cot, int n, const float* w1, const float* b1,
                   const float* wh, const float* wht, const float* bh, int n_mm,
                   const float* wl, float w0, float ww, int h, int grid,
                   float* ws_carry, float* ws_m, float* partial, float* out, void* stream) {
  return dudf::launch_bwd<kR, kT>(x, cot, 16, n, w1, b1, wh, wht, bh, n_mm, wl, w0, ww, h,
                                  grid, ws_carry, ws_m, partial, out,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
