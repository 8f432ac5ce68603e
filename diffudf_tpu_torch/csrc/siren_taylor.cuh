// Building blocks of the SIREN forward kernel K3a (csrc/vg.cu), the
// Taylor-mode forward of a uniform-width sine SIREN in the design of K1
// (csrc/vgh.cu).
//
// A CTA takes T points and runs one thread per hidden column j (blockDim =
// h).  Thread j keeps its column of the carry in registers, acc[q*T + t]
// for row group q and point t, the layout of K1 (csrc/vgh.cu):
//
//   R = 4:  [a; J0; J1; J2]                  (f and grad f:     K3a)
//   R = 10: [a; J0; J1; J2; H0..H5]          (f, grad f and h6: K1)
//
// with the packed Hessian order (xx, xy, xz, yy, yz, zz).  A hidden layer is
// one product of the whole (R*T, h) carry with W, staged in shared memory,
// followed by elementwise work on the thread's own column.  FP32 FMA
// throughout, the sin/cos of sincos.cuh, no TF32.
//
// The backward kernels K2 and K3b have their own design, on the tensor
// cores: csrc/siren_bwd.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sincos.cuh"

namespace dudf {

// acc = the first layer's carry: z = x W1 + b1, then a, J (and H) of sin(w0 z).
template <int R, int T>
__device__ __forceinline__ void first_layer(const float* xs, float wa, float wb, float wc,
                                            float bj, float w0, float* acc) {
  const float w0sq = w0 * w0;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float z = xs[3 * t] * wa + xs[3 * t + 1] * wb + xs[3 * t + 2] * wc + bj;
    float s, c;
    fast_sincos(w0 * z, &s, &c);
    const float d1 = w0 * c;
    acc[t] = s;
    acc[1 * T + t] = d1 * wa;
    acc[2 * T + t] = d1 * wb;
    acc[3 * T + t] = d1 * wc;
    if constexpr (R == 10) {
      const float d2 = -w0sq * s;
      acc[4 * T + t] = d2 * (wa * wa);
      acc[5 * T + t] = d2 * (wa * wb);
      acc[6 * T + t] = d2 * (wa * wc);
      acc[7 * T + t] = d2 * (wb * wb);
      acc[8 * T + t] = d2 * (wb * wc);
      acc[9 * T + t] = d2 * (wc * wc);
    }
  }
}

// smem[r][j] = acc[r]: the thread's column of an (RT, h) row-major block.
template <int RT>
__device__ __forceinline__ void stage_rows(float* smem, const float* acc, int h, int j) {
#pragma unroll
  for (int r = 0; r < RT; ++r) smem[r * h + j] = acc[r];
}

// acc[r] = sum_k smem[r][k] * W[k][j]: one column of (RT, h) x (h, h).
// W streams from L2, coalesced over j; the carry comes as float4 broadcasts.
template <int RT>
__device__ __forceinline__ void row_product(float* acc, const float4* smem4,
                                            const float* __restrict__ W, int h, int j) {
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.0f;
  for (int k = 0; k < h; k += 4) {
    const float wk0 = W[(k + 0) * h + j];
    const float wk1 = W[(k + 1) * h + j];
    const float wk2 = W[(k + 2) * h + j];
    const float wk3 = W[(k + 3) * h + j];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float4 c = smem4[(r * h + k) >> 2];
      acc[r] = fmaf(c.x, wk0, acc[r]);
      acc[r] = fmaf(c.y, wk1, acc[r]);
      acc[r] = fmaf(c.z, wk2, acc[r]);
      acc[r] = fmaf(c.w, wk3, acc[r]);
    }
  }
}

// The hidden activation applied to m = acc (post-product carry), in place.
template <int R, int T>
__device__ __forceinline__ void activate(float* acc, float bj, float ww) {
  const float wwsq = ww * ww;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    float s, c;
    fast_sincos(ww * (acc[t] + bj), &s, &c);
    const float d1 = ww * c;
    const float j0 = acc[1 * T + t], j1 = acc[2 * T + t], j2 = acc[3 * T + t];
    acc[t] = s;
    acc[1 * T + t] = d1 * j0;
    acc[2 * T + t] = d1 * j1;
    acc[3 * T + t] = d1 * j2;
    if constexpr (R == 10) {
      const float d2 = -wwsq * s;
      acc[4 * T + t] = d1 * acc[4 * T + t] + d2 * (j0 * j0);
      acc[5 * T + t] = d1 * acc[5 * T + t] + d2 * (j0 * j1);
      acc[6 * T + t] = d1 * acc[6 * T + t] + d2 * (j0 * j2);
      acc[7 * T + t] = d1 * acc[7 * T + t] + d2 * (j1 * j1);
      acc[8 * T + t] = d1 * acc[8 * T + t] + d2 * (j1 * j2);
      acc[9 * T + t] = d1 * acc[9 * T + t] + d2 * (j2 * j2);
    }
  }
}

constexpr int kMaxH = 256;  // threads per CTA = hidden width

}  // namespace dudf
