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
// the same arithmetic on the same staged values (so the same bits) and
// takes the first point whose rank equals the minimum.  Ties go to the
// lowest index, as torch.argmin's do in the plain version.
//
// Bound.  3 FMAs (6 FLOP) a pair: at the slice figure's 262,144 plane
// queries against a 100,000-point cloud, 1.57e11 FLOP, 2.35 ms at the FP32
// rate of 67 TFLOP/s; the bytes (queries and cloud in, distances out, about
// 4.4 MB) take 1.3 us at 3.35 TB/s, so operations bound it.  The min
// (FMNMX) takes an issue slot of its own, so a pair costs four: at one
// warp instruction a clock on each of the 132 x 4 schedulers (1.98 GHz,
// the clock the FP32 peak implies) the issue floor is 3.135 ms, and that,
// not the FMA bound, is what this design can reach.
//
// Design.  A first kernel (stage_kernel) writes the cloud once as float4
// (x, y, z, |c|^2) into the wrapper's workspace, padded to whole tiles of
// kTile points with sentinels whose rank is +inf.  The scan kernel gives
// each thread kQPT = 4 queries (one broadcast LDS.128 of a cloud point
// feeds 12 FMAs and 4 mins) and kThreads = 512 threads a CTA (at the
// figure's 262,144 queries, 128 CTAs: one an SM, four warps a scheduler);
// the cloud streams through two shared tiles, the next tile's cp.async
// copy in flight while the current one is scanned, one barrier a tile.
// More queries a thread feed more FMAs a load but leave fewer warps to
// hide latency: in turns on an H100 at 700 W (scripts/march_kernel_check.py
// --k5-variants), 8 queries a thread in 256-thread CTAs (77 registers, the
// same 2,048 queries a CTA) ran 1.4% slower, 256-thread CTAs 0.9% slower,
// 128-thread CTAs 5% slower, groups of 32 points 1.3% slower.  No padding
// leaks to the caller: the query count and the cloud size are arbitrary
// and the last CTA masks its missing queries.
//
// What holds it above the issue floor (the same runs, SM clock at 1980 MHz
// throughout): the scan's time follows its instruction count, about 1.4
// warp-clocks a pair for every one of the floor's: a two-FMA rank (three
// slots a pair, not four) takes 75% of the time, the min replaced by an
// add 95%.  What the extra clocks are (loads, the group checks, operand
// reads) was not profiled.
//
// Built by ops/min_distance.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 into a shared library with a plain C interface, loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // threads per CTA
constexpr int kQPT = 4;        // queries per thread
constexpr int kTile = 1024;    // cloud points a staged tile (16 KB)
constexpr int kGroup = 64;     // cloud points between two argmin checks

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// pts[j] = staged(cloud, j, m) for j < m_pad.
__global__ void stage_kernel(const float* __restrict__ cloud, int64_t m, int64_t m_pad,
                             float4* __restrict__ pts) {
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; j < m_pad;
       j += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    pts[j] = staged(cloud, j, m);
  }
}

__global__ void __launch_bounds__(kThreads)
    min_distance_kernel(const float* __restrict__ q, int64_t nq, const float4* __restrict__ pts,
                        int64_t m, int n_tiles, float* __restrict__ out) {
  __shared__ float4 tile[2][kTile];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads * kQPT + threadIdx.x;
  float ax[kQPT], ay[kQPT], az[kQPT], best[kQPT];
  int group[kQPT];
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

  // tile t of the staged cloud into buffer t % 2 (an empty group past the end)
  auto request = [&](int t) {
    if (t < n_tiles) {
      const float4* src = pts + static_cast<int64_t>(t) * kTile;
      for (int j = threadIdx.x; j < kTile; j += kThreads) cp_async16(&tile[t & 1][j], src + j);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  request(0);
  for (int t = 0; t < n_tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    request(t + 1);   // into tile t - 1's buffer, while tile t is scanned
    const float4* c = tile[t & 1];
    for (int g = 0; g < kTile / kGroup; ++g) {
      float gmin[kQPT];
#pragma unroll
      for (int k = 0; k < kQPT; ++k) gmin[k] = INFINITY;
#pragma unroll 16
      for (int j = 0; j < kGroup; ++j) {
        const float4 p = c[g * kGroup + j];
#pragma unroll
        for (int k = 0; k < kQPT; ++k) gmin[k] = fminf(gmin[k], rank(p, ax[k], ay[k], az[k]));
      }
#pragma unroll
      for (int k = 0; k < kQPT; ++k) {
        if (gmin[k] < best[k]) {
          best[k] = gmin[k];
          group[k] = t * kTile + g * kGroup;
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
      const float4 p = pts[j];
      if (rank(p, ax[k], ay[k], az[k]) == best[k]) {
        const float dx = q[3 * i] - p.x, dy = q[3 * i + 1] - p.y, dz = q[3 * i + 2] - p.z;
        d = sqrtf(dx * dx + dy * dy + dz * dz);
        break;
      }
    }
    out[i] = d;
  }
}

}  // namespace

extern "C" {

// Cloud points a staged tile: the workspace holds ceil(m / tile) * tile
// float4.
int min_distance_tile() { return kTile; }

// Launches K5 on `stream` and returns cudaGetLastError() (0 = ok).
// q (nq, 3), cloud (m, 3), out (nq): contiguous float32 on one device;
// work: ceil(m / min_distance_tile()) * min_distance_tile() * 4 floats,
// 16-byte aligned, written here.  m must be below 2^31 - kTile.
int min_distance_launch(const float* q, int64_t nq, const float* cloud, int64_t m, float* work,
                        float* out, void* stream) {
  if (nq < 0 || m <= 0 || m > INT32_MAX - kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = static_cast<int>((m + kTile - 1) / kTile);
  const int64_t m_pad = static_cast<int64_t>(n_tiles) * kTile;
  float4* pts = reinterpret_cast<float4*>(work);
  stage_kernel<<<static_cast<unsigned>((m_pad + 255) / 256), 256, 0, s>>>(cloud, m, m_pad, pts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_cta = static_cast<int64_t>(kThreads) * kQPT;
  const unsigned grid = static_cast<unsigned>((nq + per_cta - 1) / per_cta);
  min_distance_kernel<<<grid, kThreads, 0, s>>>(q, nq, pts, m, n_tiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
