// Brute nearest-point distance from queries to a point cloud (K5) on Hopper.
//
// Replaces diffudf_tpu/ops/pallas_distance.py::_min_dist_kernel (wrapper
// min_distance_pallas).  For each query q (Q, 3) it returns the Euclidean
// distance to the nearest point c of the cloud (M, 3): K5's function.
//
// Ranking.  Pairs are ranked by K5's expanded form, e(c) = |c|^2 - 2 q.c,
// the squared distance less |q|^2, which costs three FMAs a pair once -2q
// is held in registers.  The value K5 returns from the ranking,
// sqrt(min e + |q|^2), cancels near the surface: in float32 it errs by up
// to 7.5e-5 on the slice figure's plane queries nearest a 100k-point torus
// cloud, three quarters of K5's 1e-4 tolerance.  So this kernel carries
// the argmin through the scan, as the JAX package's XLA brute force does
// (data/mesh_distance.py::_min_sq_dist_tile), and returns the exact
// distance |q - c*| to the winner.  To keep the argmin out of the inner
// loop, a thread only remembers which group of kGroup cloud points held
// its running minimum; after the scan it walks that group once more with
// the same arithmetic (the same intrinsics, so the same bits) and takes the
// first point whose rank equals the minimum.  Ties go to the lowest index,
// as torch.argmin's do in the plain version.
//
// Design.  One thread per kQPT queries, kThreads threads a CTA.  The cloud
// streams through shared memory in tiles of kTile points stored as float4
// (x, y, z, |c|^2); points past M are sentinels whose rank is +inf.  Each
// shared load is a broadcast that feeds kQPT queries' FMAs.  No padding
// leaks to the caller: the query count and the cloud size are arbitrary
// and the last CTA masks its missing queries.
//
// Bound.  3 FMAs (6 FLOP) a pair: at the slice figure's 262,144 plane
// queries against a 100,000-point cloud, 1.57e11 FLOP, 2.35 ms at the FP32
// rate of 67 TFLOP/s; the bytes (queries and cloud in, distances out, about
// 4.4 MB) take 1.3 us at 3.35 TB/s, so operations bound it.  The min (FMNMX)
// issues beside the FMAs, so the issue rate, not the FMA pipe, is the limit
// this simple kernel meets first.  No tensor cores, no cp.async: later work.
//
// Built by ops/min_distance.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 into a shared library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per CTA
constexpr int kQPT = 4;        // queries per thread
constexpr int kTile = 1024;    // cloud points staged in shared memory at a time
constexpr int kGroup = 32;     // cloud points between two argmin checks

// Cloud point j as the scan reads it: (x, y, z, |c|^2), or a sentinel.
__device__ __forceinline__ float4 staged(const float* __restrict__ cloud, int64_t j, int64_t m) {
  if (j >= m) return make_float4(0.f, 0.f, 0.f, INFINITY);
  const float x = cloud[3 * j], y = cloud[3 * j + 1], z = cloud[3 * j + 2];
  return make_float4(x, y, z, __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
}

// |c|^2 - 2 q.c with a = -2q: three FMAs.
__device__ __forceinline__ float rank(float4 c, float ax, float ay, float az) {
  return __fmaf_rn(ax, c.x, __fmaf_rn(ay, c.y, __fmaf_rn(az, c.z, c.w)));
}

__global__ void __launch_bounds__(kThreads)
    min_distance_kernel(const float* __restrict__ q, int64_t nq, const float* __restrict__ cloud,
                        int64_t m, float* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kQPT + threadIdx.x;
  float ax[kQPT], ay[kQPT], az[kQPT], best[kQPT];
  int64_t group[kQPT];
#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * kThreads;
    const bool live = i < nq;
    ax[k] = live ? -2.f * q[3 * i] : 0.f;
    ay[k] = live ? -2.f * q[3 * i + 1] : 0.f;
    az[k] = live ? -2.f * q[3 * i + 2] : 0.f;
    best[k] = INFINITY;
    group[k] = -1;
  }

  for (int64_t t0 = 0; t0 < m; t0 += kTile) {
    __syncthreads();  // the previous tile is read by every thread
    for (int j = threadIdx.x; j < kTile; j += kThreads) tile[j] = staged(cloud, t0 + j, m);
    __syncthreads();
    const int64_t left = m - t0;
    const int n_groups = static_cast<int>(((left < kTile ? left : kTile) + kGroup - 1) / kGroup);
    for (int g = 0; g < n_groups; ++g) {
      float gmin[kQPT];
#pragma unroll
      for (int k = 0; k < kQPT; ++k) gmin[k] = INFINITY;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float4 c = tile[g * kGroup + j];
#pragma unroll
        for (int k = 0; k < kQPT; ++k) gmin[k] = fminf(gmin[k], rank(c, ax[k], ay[k], az[k]));
      }
#pragma unroll
      for (int k = 0; k < kQPT; ++k) {
        if (gmin[k] < best[k]) {
          best[k] = gmin[k];
          group[k] = t0 + g * kGroup;
        }
      }
    }
  }

  // the exact distance to the first point of the winning group that ranks
  // at the minimum; +inf when nothing ranked (no finite rank value)
#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * kThreads;
    if (i >= nq) continue;
    float d = INFINITY;
    for (int64_t j = group[k]; j >= 0 && j < group[k] + kGroup && j < m; ++j) {
      const float4 c = staged(cloud, j, m);
      if (rank(c, ax[k], ay[k], az[k]) == best[k]) {
        const float dx = q[3 * i] - c.x, dy = q[3 * i + 1] - c.y, dz = q[3 * i + 2] - c.z;
        d = sqrtf(dx * dx + dy * dy + dz * dz);
        break;
      }
    }
    out[i] = d;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// q (nq, 3), cloud (m, 3), out (nq): contiguous float32 on one device.
int min_distance_launch(const float* q, int64_t nq, const float* cloud, int64_t m, float* out,
                        void* stream) {
  if (nq < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  const int64_t per_cta = static_cast<int64_t>(kThreads) * kQPT;
  const unsigned grid = static_cast<unsigned>((nq + per_cta - 1) / per_cta);
  min_distance_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(q, nq, cloud, m,
                                                                                 out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
