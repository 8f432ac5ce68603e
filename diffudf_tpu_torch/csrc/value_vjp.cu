// s2's value path on Hopper: f(x) of a uniform-width sine SIREN, and the
// gradient of sum(f-bar * f) with respect to every W and b, as one kernel
// pair (ops/value_vjp.py).
//
// It replaces no TPU kernel.  The JAX package leaves the value path of its
// stage-2 loss (diffudf_tpu/train/losses.py::loss_s2 -> autodiff/ops.py::
// value -> fields/siren.py::siren_apply) to XLA; the port ran it as float32
// cuBLAS products and autograd's elementwise kernels, each layer's bias, w0
// scaling, sin and cos a separate trip through device memory, forward and
// backward.  Here the forward is one persistent kernel and the VJP three
// (the tile kernel, wbar_kernel and reduce_kernel of siren_bwd.cuh).
//
// What bounds it.  A point costs one (1, h) x (h, h) product a hidden layer
// forward and two backward (the carry's cotangent and W-bar): 2.75 MFLOP a
// point at 8x256, 0.02756 TFLOP at the 9,990 surface rows of a training
// batch.  As three TF32 products each on the tensor cores (3xTF32, float32
// accuracy) that is 0.167 ms at 495/3 TFLOP/s; in FP32 FMA 0.411 ms at 67.
// Its bytes are the buffers below, 0.29 GB at 9,990 rows written once and
// read once (0.17 ms at 3.35 TB/s; ops/value_vjp.py::VjpPlan.bytes_moved),
// spread over kernels whose products keep the tensor cores busy meanwhile.
//
// The design (the tiles of siren_tile.cuh at one carry row a point, R = 1):
//  - forward_kernel<T>: a persistent grid of at most one CTA per SM, h
//    threads, CTA c walking tiles c, c + G, ... of T points; warp w keeps
//    columns [32w, 32w + 32) of the tile's T rows in mma.sync accumulator
//    layout.  first_layer, then per hidden layer the 3xTF32 tile_product
//    (promoted into float32 every k-step: kPromote) whose epilogue adds the bias,
//    scales by ww and takes sin and cos (sincos.cuh) in registers.  It
//    writes what the backward reads: each product's input carry a_l (C_l,
//    in siren_bwd.cuh's K-block layout for wbar_kernel), ww cos(ww z_l) and
//    the head's input carry (D, in the order the threads hold them: one
//    float4 a lane).  The head sums each row over the thread's columns, the
//    four lanes of a row group and, in a fixed order, the warps.  Keeping
//    the residuals beat recomputing the forward in the VJP (K3b's way) by
//    0.2 ms at 9,990 rows on an H100 at 700 W (PERF.md).
//  - backward_kernel<T>: the same tiles.  Head: W_L-bar and b_L-bar from
//    f-bar, then the carry's cotangent; per hidden layer, last to first:
//    z-bar = ww cos(ww z) a-bar (D read where the cotangent is formed),
//    written once (M-bar, for wbar_kernel), then a-bar = z-bar W^T in
//    3xTF32; the first layer's z-bar from w0 cos(w0 z), recomputed from x.
//    b1-bar, W1-bar, b_L-bar (a tile's f-bar summed as a tree over a warp)
//    and W_L-bar are summed per CTA in shared memory and written once.
//  - wbar_kernel: W-bar_l = C_l^T M-bar_l and b-bar_l, split over the rows
//    into per-CTA partials; reduce_kernel adds every partial in a fixed
//    order into the flat gradient (ravel_pytree layout: per layer b then w).
// The two tile kernels promote their tensor-core sums into float32 every
// k-step (kPromote), where K2 and K3b do so every two.  The loss's cotangent
// gives every row's f-bar one large common part, so the rows' rounding
// errors in the carries and their cotangents add with one sign over 9,990
// rows; the tensor cores truncate their float32 sums, and each k-step's
// promotion halves the truncated sums of large partials a product makes.
// On an H100 that took the gradient's RMS distance from float64 from 2.9 to
// 1.7 times the float32 plain version's, for 24 us a step; wbar_kernel's
// own promotion each k-step moved nothing and cost 16 us (PERF.md).
// No float atomics: two launches on the same input give the same bits.
// Nothing is allocated here; the wrapper gives every buffer.
//
// The tile T (16 or 80 points) is the wrapper's (ops/value_vjp.py::vjp_plan):
// the one that takes the fewest rows a CTA, so that 9,990 rows make 125
// tiles of 80 on 132 SMs, one wave, and a few thousand rows (a
// data-parallel rank's share) tiles of 16.
//
// Ragged tiles: a point past n gets x = 0 and f-bar = 0, which makes every
// term it adds zero, and its f is not written.  Every width that
// kernel_io.kernel_spec_ok admits runs (a multiple of 32 up to 256), and any
// depth, n_mm = 0 too.
//
// Built by ops/value_vjp.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 into a shared library with a plain C interface, loaded with ctypes.

#include "siren_bwd.cuh"

namespace dudf {
namespace vjp {

constexpr int kPromote = 1;  // k-steps of the tile products' tensor-core sum a promotion

// float4 of the lane's accumulators (i * 4 + u) * 4 + 0..3 in a tile's
// block of a layer, stored in the order the threads hold them: a warp's
// 32 lanes write 512 contiguous bytes.
__device__ __forceinline__ int64_t reg_at(int h, int i, int u, int warp, int lane) {
  return (static_cast<int64_t>(i) * (h / 8) + 4 * warp + u) * 32 + lane;
}

// The forward of one tile: acc = the head's input carry a_{n_mm} of the
// tile's T points, whose x are xs.  Product l's input carry a_l goes to C_l,
// ww cos(ww z_l) to slot l of D and a_{n_mm} to slot n_mm (slot s of tile t
// at (s n_tiles + t) T h floats of dbuf).
template <int T>
__device__ __forceinline__ void forward_tile(float* acc, const float* xs, int tile, int n_tiles,
                                             const float* __restrict__ w1,
                                             const float* __restrict__ b1,
                                             const float4* __restrict__ frag,
                                             const float* __restrict__ bh, int n_mm, float w0,
                                             float ww, int h, float* a_hi, float* a_lo, int lda,
                                             float4* ring, float* __restrict__ cbuf,
                                             float* __restrict__ dbuf, int warp, int lane) {
  using L = Tile<1, T>;
  constexpr int MT = L::MT, kRing = L::kRing;
  const int t4 = lane & 3;
  const int64_t c_layer = bwd::kblock_rows(static_cast<int64_t>(n_tiles) * T) * h;
  const int64_t slot = static_cast<int64_t>(n_tiles) * T * h;
  float4* d_tile = reinterpret_cast<float4*>(dbuf + static_cast<int64_t>(tile) * T * h);
  const int64_t frag_layer = static_cast<int64_t>(h) * h / 4;  // float4s per orientation

  first_layer<1, T>(acc, xs, w1, b1, w0, h, warp, lane);
  for (int l = 0; l < n_mm; ++l) {
    bwd::store_columns<MT>(cbuf + l * c_layer, h, static_cast<int64_t>(tile) * T, acc, warp,
                           lane);
    stage_tile<MT>(a_hi, a_lo, lda, acc, warp, lane);
    __syncthreads();
    tile_product<MT, kRing, kPromote>(acc, a_hi, a_lo, lda, frag + (2 * l) * frag_layer, ring,
                                      h, warp, lane);
    __syncthreads();  // every warp is done reading this layer's carry
    // epilogue: bias, ww, sin and ww cos in registers; ww cos to D
    const float* b = bh + static_cast<int64_t>(l) * h;
    float4* d = d_tile + l * slot / 4;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 32 * warp + 8 * u + 2 * t4;
      const float bj[2] = {b[j], b[j + 1]};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float* c = acc + (i * 4 + u) * 4;
        float d1[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float s, co;
          fast_sincos(ww * (c[q] + bj[q & 1]), &s, &co);
          c[q] = s;
          d1[q] = ww * co;
        }
        d[reg_at(h, i, u, warp, lane)] = make_float4(d1[0], d1[1], d1[2], d1[3]);
      }
    }
  }
  float4* d = d_tile + n_mm * slot / 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* c = acc + (i * 4 + u) * 4;
      d[reg_at(h, i, u, warp, lane)] = make_float4(c[0], c[1], c[2], c[3]);
    }
  }
}

// f of every point, and C and D for backward_kernel<T>.
template <int T>
__global__ void __launch_bounds__(kMaxH, 1)
forward_kernel(const float* __restrict__ x, int n, int n_tiles, const float* __restrict__ w1,
               const float* __restrict__ b1, const float4* __restrict__ frag,
               const float* __restrict__ bh, int n_mm, const float* __restrict__ wl,
               const float* __restrict__ bl, float w0, float ww, int h, float* __restrict__ f,
               float* __restrict__ cbuf, float* __restrict__ dbuf) {
  using L = Tile<1, T>;
  constexpr int TH = L::TH, kRing = L::kRing, kWarps = kMaxH / 32;
  extern __shared__ float4 smem4[];
  const int lda = h + kPad;
  float* a_hi = reinterpret_cast<float*>(smem4);  // (T, h + kPad): TF32 hi of the carry
  float* a_lo = a_hi + T * lda;                   // and its lo
  __shared__ float xs[T * 3];
  __shared__ float part[T * kWarps];  // part[t * kWarps + w]: warp w's sum of row t

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_warps = blockDim.x >> 5;
  // this lane's slots of its warp's ring: [kRing][4][32 lanes] float4
  float4* ring = smem4 + (2 * T * lda) / 4 + warp * (kRing * 4 * 32) + lane;
  float acc[T];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t base = static_cast<int64_t>(tile) * T;
    __syncthreads();  // xs and part are free
    for (int i = tid; i < T * 3; i += blockDim.x) {
      xs[i] = base + i / 3 < n ? x[base * 3 + i] : 0.0f;
    }
    __syncthreads();

    forward_tile<T>(acc, xs, tile, n_tiles, w1, b1, frag, bh, n_mm, w0, ww, h, a_hi, a_lo, lda,
                    ring, cbuf, dbuf, warp, lane);

    // ---- head: each row dotted with W_L --------------------------------------
    float v[TH];
#pragma unroll
    for (int th = 0; th < TH; ++th) v[th] = 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float wlj = wl[32 * warp + 8 * u + 2 * t4 + e];
#pragma unroll
        for (int th = 0; th < TH; ++th) v[th] = fmaf(acc[L::idx(0, th, u, e)], wlj, v[th]);
      }
    }
#pragma unroll
    for (int th = 0; th < TH; ++th) {
      float s = v[th];  // the four lanes of row group g hold the warp's 32 columns
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t4 == 0) part[(g + 8 * th) * kWarps + warp] = s;
    }
    __syncthreads();
    for (int t = tid; t < T; t += blockDim.x) {
      if (base + t >= n) continue;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w) s += part[t * kWarps + w];
      f[base + t] = s + bl[0];
    }
  }
}

// The gradient's per-tile part from forward_kernel<T>'s D: M-bar of every
// hidden product, and each CTA's sums of b1-bar, W1-bar, b_L-bar and
// W_L-bar (bwd::small_size(h) floats a CTA, in that order).
template <int T>
__global__ void __launch_bounds__(kMaxH, 1)
backward_kernel(const float* __restrict__ x, const float* __restrict__ fbar, int n, int n_tiles,
                const float* __restrict__ w1, const float* __restrict__ b1,
                const float4* __restrict__ frag, int n_mm, const float* __restrict__ wl,
                float w0, float ww, int h, const float* __restrict__ dbuf,
                float* __restrict__ mbar, float* __restrict__ small) {
  using L = Tile<1, T>;
  constexpr int MT = L::MT, TH = L::TH, kRing = L::kRing;
  extern __shared__ float4 smem4[];
  const int lda = h + kPad;
  float* a_hi = reinterpret_cast<float*>(smem4);
  float* a_lo = a_hi + T * lda;
  __shared__ float xs[T * 3];
  __shared__ float cs[T];  // f-bar of the tile's points
  __shared__ float s_small[bwd::small_size(kMaxH)];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float4* ring = smem4 + (2 * T * lda) / 4 + warp * (kRing * 4 * 32) + lane;
  const int64_t c_layer = bwd::kblock_rows(static_cast<int64_t>(n_tiles) * T) * h;
  const int64_t slot = static_cast<int64_t>(n_tiles) * T * h;
  const int64_t frag_layer = static_cast<int64_t>(h) * h / 4;
  float* s_b1 = s_small;
  float* s_w1 = s_small + h;
  float* s_bl = s_small + 4 * h;
  float* s_wl = s_small + 4 * h + 1;
  for (int i = tid; i < bwd::small_size(h); i += blockDim.x) s_small[i] = 0.0f;

  float acc[T];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t base = static_cast<int64_t>(tile) * T;
    const float4* d_tile = reinterpret_cast<const float4*>(dbuf + base * h);
    __syncthreads();  // xs, cs and s_small are free
    for (int i = tid; i < T * 3; i += blockDim.x) {
      xs[i] = base + i / 3 < n ? x[base * 3 + i] : 0.0f;
    }
    for (int t = tid; t < T; t += blockDim.x) cs[t] = base + t < n ? fbar[base + t] : 0.0f;
    __syncthreads();

    {  // the head's input carry a_{n_mm}
      const float4* d = d_tile + n_mm * slot / 4;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v = d[reg_at(h, i, u, warp, lane)];
          float* c = acc + (i * 4 + u) * 4;
          c[0] = v.x;
          c[1] = v.y;
          c[2] = v.z;
          c[3] = v.w;
        }
      }
    }

    // ---- head: W_L-bar, b_L-bar, and the carry's cotangent -----------------
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 32 * warp + 8 * u + 2 * t4 + e;
        const float wlj = wl[j];
        float gsum = 0.0f;
#pragma unroll
        for (int th = 0; th < TH; ++th) {
          const float fb = cs[g + 8 * th];
          gsum = fmaf(fb, acc[L::idx(0, th, u, e)], gsum);
          acc[L::idx(0, th, u, e)] = fb * wlj;
        }
        gsum = bwd::sum_g(gsum);
        if (g == 0) s_wl[j] += gsum;
      }
    }
    if (warp == 0) {  // the tile's f-bar: a lane's few rows, then a tree over the warp
      float fb = 0.0f;
      for (int t = lane; t < T; t += 32) fb += cs[t];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) fb += __shfl_xor_sync(0xffffffffu, fb, o);
      if (lane == 0) *s_bl += fb;
    }

    // ---- hidden layers, last to first: M-bar out, a-bar = z-bar W^T --------
    for (int l = n_mm - 1; l >= 0; --l) {
      const float4* d = d_tile + l * slot / 4;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v = d[reg_at(h, i, u, warp, lane)];
          float* c = acc + (i * 4 + u) * 4;
          c[0] *= v.x;
          c[1] *= v.y;
          c[2] *= v.z;
          c[3] *= v.w;
        }
      }
      bwd::store_columns<MT>(mbar + l * c_layer, h, base, acc, warp, lane);
      stage_tile<MT>(a_hi, a_lo, lda, acc, warp, lane);
      __syncthreads();
      tile_product<MT, kRing, kPromote>(acc, a_hi, a_lo, lda, frag + (2 * l + 1) * frag_layer,
                                        ring, h, warp, lane);
      __syncthreads();  // the A buffer is free again
    }

    // ---- first layer: z-bar = w0 cos(w0 z) a-bar, z recomputed from x ------
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 32 * warp + 8 * u + 2 * t4 + e;
        const float wa = w1[j], wb = w1[h + j], wc = w1[2 * h + j], bj = b1[j];
        float zs = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
#pragma unroll
        for (int th = 0; th < TH; ++th) {
          const int t = g + 8 * th;
          const float z =
              fmaf(xs[3 * t + 2], wc, fmaf(xs[3 * t + 1], wb, xs[3 * t] * wa)) + bj;
          float s, c;
          fast_sincos(w0 * z, &s, &c);
          const float zbar = (w0 * c) * acc[L::idx(0, th, u, e)];
          zs += zbar;
          g0 = fmaf(xs[3 * t], zbar, g0);
          g1 = fmaf(xs[3 * t + 1], zbar, g1);
          g2 = fmaf(xs[3 * t + 2], zbar, g2);
        }
        zs = bwd::sum_g(zs);
        g0 = bwd::sum_g(g0);
        g1 = bwd::sum_g(g1);
        g2 = bwd::sum_g(g2);
        if (g == 0) {
          s_b1[j] += zs;
          s_w1[j] += g0;
          s_w1[h + j] += g1;
          s_w1[2 * h + j] += g2;
        }
      }
    }
  }
  __syncthreads();
  float* out = small + static_cast<int64_t>(blockIdx.x) * bwd::small_size(h);
  for (int i = tid; i < bwd::small_size(h); i += blockDim.x) out[i] = s_small[i];
}

inline bool bad_width(int h) { return h % 32 != 0 || h > kMaxH || h <= 0; }

inline int n_tiles_of(int n, int tile) {
  return static_cast<int>((static_cast<int64_t>(n) + tile - 1) / tile);
}

template <int T>
int forward(const float* x, int n, const float* w1, const float* b1, const float* wh,
            const float* bh, int n_mm, const float* wl, const float* bl, float w0, float ww,
            int h, int grid, float* frag, float* cbuf, float* dbuf, float* f, cudaStream_t s) {
  if (bad_width(h) || n < 0 || n_mm < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = n_tiles_of(n, T);
  if (n_tiles == 0) return 0;
  if (grid <= 0 || grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (n_mm > 0) {  // W and W^T, the backward's too
    frag_kernel<<<264, 256, 0, s>>>(wh, n_mm, 2, h, reinterpret_cast<float4*>(frag));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = Tile<1, T>::smem_bytes(h);
  err = cudaFuncSetAttribute(forward_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  forward_kernel<T><<<grid, h, smem, s>>>(x, n, n_tiles, w1, b1,
                                          reinterpret_cast<const float4*>(frag), bh, n_mm, wl, bl,
                                          w0, ww, h, f, cbuf, dbuf);
  return static_cast<int>(cudaGetLastError());
}

template <int T>
int backward(const float* x, const float* fbar, int n, const float* w1, const float* b1,
             int n_mm, const float* wl, float w0, float ww, int h, int grid, int n_split,
             int64_t split_rows, const float* frag, const float* cbuf, const float* dbuf,
             float* mbar, float* small, float* wpart, float* out, cudaStream_t s) {
  if (bad_width(h) || n < 0 || n_mm < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t p_size = 4 * static_cast<int64_t>(h) +
                         static_cast<int64_t>(n_mm) * (h + static_cast<int64_t>(h) * h) + 1 + h;
  const int n_tiles = n_tiles_of(n, T);
  if (n_tiles == 0) return static_cast<int>(cudaMemsetAsync(out, 0, p_size * sizeof(float), s));
  const int64_t k_rows = static_cast<int64_t>(n_tiles) * T;
  if (grid <= 0 || grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (n_mm > 0 && (n_split <= 0 || split_rows % bwd::kChunk != 0 ||
                   static_cast<int64_t>(n_split) * split_rows < k_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = Tile<1, T>::smem_bytes(h);
  cudaError_t err = cudaFuncSetAttribute(backward_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  backward_kernel<T><<<grid, h, smem, s>>>(x, fbar, n, n_tiles, w1, b1,
                                           reinterpret_cast<const float4*>(frag), n_mm, wl, w0,
                                           ww, h, dbuf, mbar, small);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_mm > 0) {
    const int smem2 = bwd::kStages2 * 2 * bwd::kBlk * bwd::kLd2 * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(bwd::wbar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem2);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nb = (h + bwd::kBlk - 1) / bwd::kBlk;
    bwd::wbar_kernel<<<dim3(nb * nb, n_split, n_mm), 256, smem2, s>>>(cbuf, mbar, h, k_rows, T,
                                                                       T, split_rows, wpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned rgrid = static_cast<unsigned>((p_size + 255) / 256);
  bwd::reduce_kernel<<<rgrid, 256, 0, s>>>(small, grid, wpart, n_split, h, n_mm, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace vjp
}  // namespace dudf

extern "C" {

// The forward on `stream`: f (n) and the residuals; -> cudaGetLastError()
// (0 = ok).  x (n, 3); w1 (3, h); b1 (h); wh (n_mm, h, h); bh (n_mm, h); wl
// (h); bl (1); tile points a tile (16 or 80) and grid CTAs (at most
// the tiles); frag 2 n_mm h^2 floats, which the backward reads too; cbuf
// n_mm h K32 and dbuf (n_mm + 1) K h floats (K = tile * tiles rows, K32 = K
// rounded up to 32), as ops/value_vjp.py::VjpPlan.sizes gives them.  All
// float32, contiguous, on one device.
int value_vjp_fwd_launch(const float* x, int n, const float* w1, const float* b1,
                         const float* wh, const float* bh, int n_mm, const float* wl,
                         const float* bl, float w0, float ww, int h, int tile, int grid,
                         float* frag, float* cbuf, float* dbuf, float* f, void* stream) {
  using dudf::vjp::forward;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16: return forward<16>(x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h, grid, frag, cbuf,
                                dbuf, f, s);
    case 80: return forward<80>(x, n, w1, b1, wh, bh, n_mm, wl, bl, w0, ww, h, grid, frag, cbuf,
                                dbuf, f, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The VJP on `stream`: the gradient of sum(fbar * f), flat, into out
// (ravel_pytree layout); -> cudaGetLastError().  fbar (n); frag, cbuf and
// dbuf as the forward wrote them; mbar as cbuf; small grid (5h + 1) floats;
// wpart n_mm n_split (h^2 + h) floats; n_split runs of split_rows rows (a
// multiple of 32) of W-bar's split-K product.  The other arguments as the
// forward's, the same tile and grid.
int value_vjp_bwd_launch(const float* x, const float* fbar, int n, const float* w1,
                         const float* b1, int n_mm, const float* wl, float w0, float ww, int h,
                         int tile, int grid, int n_split, long long split_rows,
                         const float* frag, const float* cbuf, const float* dbuf, float* mbar,
                         float* small, float* wpart, float* out, void* stream) {
  using dudf::vjp::backward;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16: return backward<16>(x, fbar, n, w1, b1, n_mm, wl, w0, ww, h, grid, n_split,
                                 split_rows, frag, cbuf, dbuf, mbar, small, wpart, out, s);
    case 80: return backward<80>(x, fbar, n, w1, b1, n_mm, wl, w0, ww, h, grid, n_split,
                                 split_rows, frag, cbuf, dbuf, mbar, small, wpart, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
