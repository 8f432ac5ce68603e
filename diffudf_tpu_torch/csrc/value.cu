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
// float32; the hidden and head products take bf16 operands: each
// activation is rounded to bf16 (__float2bfloat16_rn) where it is staged,
// and the weights arrive in bf16 from the wrapper.  The products of two bf16
// values are exact in float32, so the mode computes the same function as
// the plain version value_reference (ops/value.py) up to the order of the
// sums.  The sin is the shared polynomial of sincos.cuh (fast_sin).
//
// Design: dudf::fwd::launch<1, T, P> of siren_fwd.cuh, the persistent tile
// design of K1 and K3a with a value-only carry (R = 1): a grid of at most
// one CTA per SM walks tiles of T points, h threads, warp w holding columns
// [32w, 32w + 32) of the tile's T rows in mma.sync accumulator layout.
//  - bf16: Product::kBf16, the carry staged in bf16 and multiplied on the
//    tensor cores (mma.sync.m16n8k16, float32 sums) by W's bf16 fragments,
//    which the wrapper lays out once per trace (kernel_io.value_fragments)
//    and each lane streams from L2 through a cp.async ring that runs on
//    across layers and tiles.
//  - f32: Product::kFp32, K1's product: each thread's rows by 8 columns
//    summed in FP32 FMA over k in turn, the plain version's order, W's rows
//    through a shared ring.
// The tile T is the caller's (kernel_io.ValuePlan picks it per bucket:
// 128 points at the march's 65,536- and 16,384-point buckets, 32 at 4,096,
// 16 at 1,024), so that the small buckets still spread over the SMs; a
// point's bits do not depend on T.
//
// Bound.  At 8x256 a point costs about 0.92 MFLOP (7 hidden products of
// 2*256^2, the first layer 2*3*256 and the head 2*256) against 16 bytes in
// and out.  The bf16 mode at the dense bf16 tensor rate (989 TFLOP/s) needs
// 0.061 ms for 65,536 points; the f32 mode at the FP32 FMA rate (67
// TFLOP/s) 0.899 ms.  Every tile re-reads W from L2 (0.92 MB in bf16 a
// tile): at 65,536 points in tiles of 128, 0.47 GB a launch.
//
// Built by ops/value.py with nvcc -gencode arch=compute_90a,code=sm_90a -O3
// into a shared library with a plain C interface, loaded with ctypes.

#include "siren_fwd.cuh"

namespace {

using dudf::fwd::Product;

template <int T>
int run(const float* x, int n, const float* w1, const float* b1, const void* w,
        const float* bh, int n_mm, const float* wl, const float* bl, float w0, float ww, int h,
        int mixed, int grid, float* out, cudaStream_t s) {
  if (mixed) {
    return dudf::fwd::launch<1, T, Product::kBf16>(
        x, n, w1, b1, nullptr, bh, n_mm, wl, bl, w0, ww, h, grid,
        const_cast<float*>(static_cast<const float*>(w)), out, 1, s);
  }
  return dudf::fwd::launch<1, T, Product::kFp32>(x, n, w1, b1, static_cast<const float*>(w), bh,
                                                 n_mm, wl, bl, w0, ww, h, grid, nullptr, out, 1,
                                                 s);
}

template <int T>
int smem(int h, int mixed) {
  return mixed ? dudf::fwd::smem_bytes<1, T, Product::kBf16>(h)
               : dudf::fwd::smem_bytes<1, T, Product::kFp32>(h);
}

}  // namespace

extern "C" {

// Dynamic shared bytes of one CTA at tile T (16, 32, 64 or 128) and width
// h; -1 for a tile the library is not built for.
int value_smem(int tile, int h, int mixed) {
  switch (tile) {
    case 16: return smem<16>(h, mixed);
    case 32: return smem<32>(h, mixed);
    case 64: return smem<64>(h, mixed);
    case 128: return smem<128>(h, mixed);
    default: return -1;
  }
}

// Launches K4 on `stream` and returns cudaGetLastError() (0 = ok).
// x (n, 3); w1 (3, h); b1 (h); bh (n_mm, h); bl (1); out (n); float32.
// mixed = 0: w is W of the hidden layers, (n_mm, h, h) float32, and wl
// (h) W_last.  mixed = 1: w is their bf16 fragments (kernel_io.
// value_fragments) and wl W_last rounded to bf16, held in float32.  tile
// points a tile (16, 32, 64 or 128) and grid CTAs, at most the tiles, as
// ops/kernel_io.py::ValuePlan gives them.  h must be a multiple of 32 and
// at most 256.  All contiguous, on the same device.
int value_launch(const float* x, int n, const float* w1, const float* b1, const void* w,
                 const float* bh, int n_mm, const float* wl, const float* bl, float w0,
                 float ww, int h, int mixed, int tile, int grid, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16: return run<16>(x, n, w1, b1, w, bh, n_mm, wl, bl, w0, ww, h, mixed, grid, out, s);
    case 32: return run<32>(x, n, w1, b1, w, bh, n_mm, wl, bl, w0, ww, h, mixed, grid, out, s);
    case 64: return run<64>(x, n, w1, b1, w, bh, n_mm, wl, bl, w0, ww, h, mixed, grid, out, s);
    case 128: return run<128>(x, n, w1, b1, w, bh, n_mm, wl, bl, w0, ww, h, mixed, grid, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
