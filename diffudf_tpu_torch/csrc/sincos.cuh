// Shared-range-reduction sin/cos for the SIREN kernels.
//
// Device counterpart of diffudf_tpu/ops/sincos.py (inlined by every Pallas
// SIREN kernel there) and of diffudf_tpu_torch/ops/sincos.py: one Cody-Waite
// reduction by a 3-float split of 2*pi feeds an odd (sin) and an even (cos)
// minimax polynomial, with the same float32 constants.  CUDA's sincosf and
// __sinf compute other functions, so the kernels call these instead.
// rintf rounds half to even, as jnp.round and torch.round do.  Build without
// -use_fast_math.
#pragma once

namespace dudf {

__device__ __forceinline__ float reduce_two_pi(float z) {
  const float q = rintf(z * 0.15915494309189535f);
  return ((z - q * 6.28125f) - q * 0.0019353071f) - q * 1.0253132e-11f;
}

__device__ __forceinline__ float sin_poly(float r, float u) {
  float p = 1.3449976e-10f;
  p = p * u + -2.4676488e-08f;
  p = p * u + 2.7529395e-06f;
  p = p * u + -0.00019840153f;
  p = p * u + 0.0083333105f;
  p = p * u + -0.16666664f;
  p = p * u + 1.0f;
  return r * p;
}

__device__ __forceinline__ float cos_poly(float u) {
  float p = -9.7225665e-12f;
  p = p * u + 2.0603605e-09f;
  p = p * u + -2.7534804e-07f;
  p = p * u + 2.4800554e-05f;
  p = p * u + -0.0013888864f;
  p = p * u + 0.041666664f;
  p = p * u + -0.5f;
  p = p * u + 1.0f;
  return p;
}

__device__ __forceinline__ void fast_sincos(float z, float* s, float* c) {
  const float r = reduce_two_pi(z);
  const float u = r * r;
  *s = sin_poly(r, u);
  *c = cos_poly(u);
}

__device__ __forceinline__ float fast_sin(float z) {
  const float r = reduce_two_pi(z);
  return sin_poly(r, r * r);
}

}  // namespace dudf
