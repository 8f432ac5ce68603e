// Building blocks of the SIREN training kernels K2, K3a and K3b, and the
// backward kernel they share.
//
// A CTA takes T points and runs one thread per hidden column j (blockDim =
// h).  Thread j keeps its column of the carry in registers, acc[q*T + t]
// for row group q and point t, the layout of K1 (csrc/vgh.cu):
//
//   R = 4:  [a; J0; J1; J2]                  (f and grad f:     K3a, K3b)
//   R = 10: [a; J0; J1; J2; H0..H5]          (f, grad f and h6: K1,  K2)
//
// with the packed Hessian order (xx, xy, xz, yy, yz, zz).  A hidden layer is
// one product of the whole (R*T, h) carry with W, staged in shared memory,
// followed by elementwise work on the thread's own column.  FP32 FMA
// throughout, the sin/cos of sincos.cuh, no TF32.
//
// siren_bwd_kernel<R, T> is the hand-derived VJP of that forward with
// respect to every W and b: the backward of
// diffudf_tpu/ops/pallas_vgh_vjp.py::_vgh_bwd_kernel (R = 10) and of
// diffudf_tpu/ops/pallas_vg.py::_vg_bwd_kernel (R = 4), term for term.
//
// What differs from the Pallas kernels, and why.
//  * Residuals.  Pallas keeps every layer's carry and d1/d2 of a tile in
//    VMEM.  At R = 10 that is 640 KB even at T = 8, and a block has 227 KB.
//    Here the forward recompute writes, per layer, the carry that enters the
//    product and the product's result m to a device-memory workspace that
//    belongs to the CTA (2 * (L-1) * R*T*h floats, 1.1 MB at 8x256, R = 10):
//    the backward reads m instead of running the forward product again, and
//    recomputes d1 and d2 from m's first T rows.  That saves one of the four
//    products per layer of the Pallas backward.  Recomputing the carries
//    instead of storing them would cost about L^2/2 forward layers.
//  * Weight gradients.  The Pallas grid is sequential and adds every tile
//    into one output block.  Here the grid is persistent: G CTAs (at most
//    one per SM), CTA c walks tiles c, c + G, c + 2G, ... and keeps its own
//    partial sums of every gradient in the workspace (its first tile stores,
//    later tiles add).  siren_reduce_kernel then adds the G partials in a
//    fixed order, in blocks of 16.  No float atomics: two runs on the same
//    card give the same bits.  The partial's layout is the flat layout of
//    jax.flatten_util.ravel_pytree over the JAX params: per layer b then w.
//  * W-bar = carry_in^T * mbar is a hand-written product: thread j holds
//    mbar's column j in registers and reads carry_in's rows as float4
//    broadcasts from shared memory (staged there in the [k][r] layout it
//    was written in).  carrybar = mbar * W^T reads a transposed copy of the
//    weights so that the loads stay coalesced.
//  * Ragged tiles.  A point past n gets a zero cotangent and x = 0, which
//    makes every term it adds zero; the caller pads nothing.

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

// dst = src (first tile of the CTA) or dst += src.
__device__ __forceinline__ void put(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// Offsets of the ravel_pytree layout: per layer b then w.
struct FlatLayout {
  int h, n_mm;
  __device__ __forceinline__ int64_t b1() const { return 0; }
  __device__ __forceinline__ int64_t w1() const { return h; }
  __device__ __forceinline__ int64_t bh(int l) const {
    return 4 * static_cast<int64_t>(h) + static_cast<int64_t>(l) * (h + static_cast<int64_t>(h) * h);
  }
  __device__ __forceinline__ int64_t wh(int l) const { return bh(l) + h; }
  __device__ __forceinline__ int64_t bl() const { return bh(n_mm); }
  __device__ __forceinline__ int64_t wl() const { return bl() + 1; }
};

constexpr int kMaxH = 256;  // threads per CTA = hidden width

// Dynamic shared memory of siren_bwd_kernel: two (R*T, h) blocks.
template <int R, int T>
constexpr int bwd_smem_bytes(int h) { return 2 * R * T * h * static_cast<int>(sizeof(float)); }

template <int R, int T>
__global__ void __launch_bounds__(kMaxH, 1)
siren_bwd_kernel(const float* __restrict__ x, const float* __restrict__ cot, int cot_stride,
                 int n, int n_tiles,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ wh, const float* __restrict__ wht,
                 const float* __restrict__ bh, int n_mm,
                 const float* __restrict__ wl, float w0, float ww, int h,
                 float* __restrict__ ws_carry, float* __restrict__ ws_m,
                 float* __restrict__ partial, int64_t p_size) {
  constexpr int RT = R * T;
  extern __shared__ float4 smem4[];
  float* rows_s = reinterpret_cast<float*>(smem4);  // (RT, h): carry, then mbar
  float* colT_s = rows_s + RT * h;                  // (h, RT): carry_in, [k][r]
  const float4* colT4 = smem4 + (RT * h) / 4;
  __shared__ float xs[T * 3];
  __shared__ float cs[T * R];  // cs[t * R + q]: the cotangent of row group q

  const int j = threadIdx.x;
  const int64_t block = static_cast<int64_t>(RT) * h;
  float* my_carry = ws_carry + blockIdx.x * n_mm * block;
  float* my_m = ws_m + blockIdx.x * n_mm * block;
  float* my_p = partial + blockIdx.x * p_size;
  const FlatLayout lay{h, n_mm};
  const float wa = w1[j], wb = w1[h + j], wc = w1[2 * h + j], b1j = b1[j];
  const float wwsq = ww * ww, w0sq = w0 * w0;
  const float wlj = wl[j];

  float acc[RT];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const bool first = tile == static_cast<int>(blockIdx.x);
    const int64_t base = static_cast<int64_t>(tile) * T;
    for (int i = j; i < T * 3; i += blockDim.x) {
      xs[i] = base + i / 3 < n ? x[base * 3 + i] : 0.0f;
    }
    for (int i = j; i < T * R; i += blockDim.x) {
      const int64_t p = base + i / R;
      cs[i] = p < n ? cot[p * cot_stride + i % R] : 0.0f;
    }
    __syncthreads();

    // ---- forward recompute: keep each product's input and output ----------
    first_layer<R, T>(xs, wa, wb, wc, b1j, w0, acc);
    for (int l = 0; l < n_mm; ++l) {
      float4* cdst = reinterpret_cast<float4*>(my_carry + l * block + static_cast<int64_t>(j) * RT);
#pragma unroll
      for (int r = 0; r < RT; r += 4) cdst[r / 4] = make_float4(acc[r], acc[r + 1], acc[r + 2], acc[r + 3]);
      stage_rows<RT>(rows_s, acc, h, j);
      __syncthreads();
      row_product<RT>(acc, smem4, wh + static_cast<int64_t>(l) * h * h, h, j);
      __syncthreads();  // every thread is done reading this layer's carry
      float* mdst = my_m + l * block;
#pragma unroll
      for (int r = 0; r < RT; ++r) mdst[r * h + j] = acc[r];
      activate<R, T>(acc, bh[static_cast<int64_t>(l) * h + j], ww);
    }

    // ---- head: W_L-bar, b_L-bar, and the carry's cotangent ---------------
    {
      float g = 0.0f;
#pragma unroll
      for (int q = 0; q < R; ++q) {
#pragma unroll
        for (int t = 0; t < T; ++t) g = fmaf(cs[t * R + q], acc[q * T + t], g);
      }
      put(my_p + lay.wl() + j, g, first);
      if (j == 0) {
        float fb = 0.0f;
        for (int t = 0; t < T; ++t) fb += cs[t * R];
        put(my_p + lay.bl(), fb, first);
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
#pragma unroll
        for (int t = 0; t < T; ++t) acc[q * T + t] = cs[t * R + q] * wlj;
      }
    }

    // ---- hidden layers, last to first -------------------------------------
    for (int l = n_mm - 1; l >= 0; --l) {
      const float* m = my_m + l * block;
      const float bj = bh[static_cast<int64_t>(l) * h + j];
      float zsum = 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        float s, c;
        fast_sincos(ww * (m[t * h + j] + bj), &s, &c);
        const float d1 = ww * c;
        const float d2 = -wwsq * s;
        const float jz0 = m[(1 * T + t) * h + j];
        const float jz1 = m[(2 * T + t) * h + j];
        const float jz2 = m[(3 * T + t) * h + j];
        const float ab = acc[t];
        const float jb0 = acc[1 * T + t], jb1 = acc[2 * T + t], jb2 = acc[3 * T + t];
        const float sum_j = jb0 * jz0 + jb1 * jz1 + jb2 * jz2;
        float zbar;
        if constexpr (R == 10) {
          float hz[6], hb[6];
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            hz[q] = m[((4 + q) * T + t) * h + j];
            hb[q] = acc[(4 + q) * T + t];
          }
          float sum_h = 0.0f;
#pragma unroll
          for (int q = 0; q < 6; ++q) sum_h += hb[q] * hz[q];
          const float sum_o = hb[0] * (jz0 * jz0) + hb[1] * (jz0 * jz1) + hb[2] * (jz0 * jz2) +
                              hb[3] * (jz1 * jz1) + hb[4] * (jz1 * jz2) + hb[5] * (jz2 * jz2);
          zbar = d1 * ab + d2 * (sum_j + sum_h) - wwsq * d1 * sum_o;
          acc[1 * T + t] = d1 * jb0 + d2 * (2.0f * hb[0] * jz0 + hb[1] * jz1 + hb[2] * jz2);
          acc[2 * T + t] = d1 * jb1 + d2 * (hb[1] * jz0 + 2.0f * hb[3] * jz1 + hb[4] * jz2);
          acc[3 * T + t] = d1 * jb2 + d2 * (hb[2] * jz0 + hb[4] * jz1 + 2.0f * hb[5] * jz2);
#pragma unroll
          for (int q = 0; q < 6; ++q) acc[(4 + q) * T + t] = d1 * hb[q];
        } else {
          zbar = d1 * ab + d2 * sum_j;
          acc[1 * T + t] = d1 * jb0;
          acc[2 * T + t] = d1 * jb1;
          acc[3 * T + t] = d1 * jb2;
        }
        acc[t] = zbar;
        zsum += zbar;
      }
      put(my_p + lay.bh(l) + j, zsum, first);
      stage_rows<RT>(rows_s, acc, h, j);  // mbar, (RT, h)
      {
        const float4* src = reinterpret_cast<const float4*>(my_carry + l * block);
        float4* dst = reinterpret_cast<float4*>(colT_s);
        for (int i = j; i < block / 4; i += blockDim.x) dst[i] = src[i];
      }
      __syncthreads();

      // W-bar[k][j] += sum_r carry_in[r][k] * mbar[r][j], eight k at a time,
      // the next eight partial sums loaded while these are computed.
      float* wbar = my_p + lay.wh(l);
      constexpr int KB = 8;
      float cur[KB], nxt[KB];
#pragma unroll
      for (int i = 0; i < KB; ++i) cur[i] = first ? 0.0f : wbar[i * h + j];
      for (int k0 = 0; k0 < h; k0 += KB) {
        const bool more = !first && k0 + KB < h;
#pragma unroll
        for (int i = 0; i < KB; ++i) nxt[i] = more ? wbar[(k0 + KB + i) * h + j] : 0.0f;
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          const float4* col = colT4 + ((k0 + i) * RT) / 4;
          float d = 0.0f;
#pragma unroll
          for (int r = 0; r < RT; r += 4) {
            const float4 c = col[r / 4];
            d = fmaf(c.x, acc[r], d);
            d = fmaf(c.y, acc[r + 1], d);
            d = fmaf(c.z, acc[r + 2], d);
            d = fmaf(c.w, acc[r + 3], d);
          }
          wbar[(k0 + i) * h + j] = cur[i] + d;
        }
#pragma unroll
        for (int i = 0; i < KB; ++i) cur[i] = nxt[i];
      }

      // carrybar[r][j] = sum_k mbar[r][k] * W[j][k], from W^T.
      row_product<RT>(acc, smem4, wht + static_cast<int64_t>(l) * h * h, h, j);
      __syncthreads();
    }

    // ---- first layer -------------------------------------------------------
    {
      float zs = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float z = xs[3 * t] * wa + xs[3 * t + 1] * wb + xs[3 * t + 2] * wc + b1j;
        float s, c;
        fast_sincos(w0 * z, &s, &c);
        const float d1 = w0 * c;
        const float d2 = -w0sq * s;
        const float ab = acc[t];
        const float jb0 = acc[1 * T + t], jb1 = acc[2 * T + t], jb2 = acc[3 * T + t];
        float zbar = d1 * ab + d2 * (jb0 * wa + jb1 * wb + jb2 * wc);
        float e0 = jb0 * d1, e1 = jb1 * d1, e2 = jb2 * d1;  // direct terms
        if constexpr (R == 10) {
          const float hb0 = acc[4 * T + t], hb1 = acc[5 * T + t], hb2 = acc[6 * T + t];
          const float hb3 = acc[7 * T + t], hb4 = acc[8 * T + t], hb5 = acc[9 * T + t];
          const float sum_hw = hb0 * (wa * wa) + hb1 * (wa * wb) + hb2 * (wa * wc) +
                               hb3 * (wb * wb) + hb4 * (wb * wc) + hb5 * (wc * wc);
          zbar -= w0sq * d1 * sum_hw;
          // d(H1)/d(W1 row k): H_q = d2 * w_i * w_j for q = (i, j)
          e0 += d2 * (2.0f * hb0 * wa + hb1 * wb + hb2 * wc);
          e1 += d2 * (hb1 * wa + 2.0f * hb3 * wb + hb4 * wc);
          e2 += d2 * (hb2 * wa + hb4 * wb + 2.0f * hb5 * wc);
        }
        zs += zbar;
        g0 += xs[3 * t] * zbar + e0;
        g1 += xs[3 * t + 1] * zbar + e1;
        g2 += xs[3 * t + 2] * zbar + e2;
      }
      put(my_p + lay.b1() + j, zs, first);
      put(my_p + lay.w1() + j, g0, first);
      put(my_p + lay.w1() + h + j, g1, first);
      put(my_p + lay.w1() + 2 * h + j, g2, first);
    }
    __syncthreads();  // xs and cs are rewritten by the next tile
  }
}

// out[e] = the sum over c = 0..g-1 of partial[c][e], in a fixed order:
// blocks of kReduceBlock consecutive CTAs summed in order, then the block
// sums in order.  Twenty-some additions deep instead of g (132 on an H100).
constexpr int kReduceBlock = 16;

__global__ void siren_reduce_kernel(const float* __restrict__ partial, int g, int64_t p_size,
                                    float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= p_size) return;
  float s = 0.0f;
  for (int c0 = 0; c0 < g; c0 += kReduceBlock) {
    const int c1 = c0 + kReduceBlock < g ? c0 + kReduceBlock : g;
    float b = 0.0f;
    for (int c = c0; c < c1; ++c) b += partial[c * p_size + e];
    s += b;
  }
  out[e] = s;
}

// Launches the backward and the reduction on `stream`; -> cudaGetLastError().
template <int R, int T>
int launch_bwd(const float* x, const float* cot, int cot_stride, int n,
               const float* w1, const float* b1, const float* wh, const float* wht,
               const float* bh, int n_mm, const float* wl, float w0, float ww, int h,
               int grid, float* ws_carry, float* ws_m, float* partial, float* out,
               cudaStream_t stream) {
  if (h % 32 != 0 || h > kMaxH || h <= 0 || grid <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t p_size = 4 * static_cast<int64_t>(h) + static_cast<int64_t>(n_mm) * (h + static_cast<int64_t>(h) * h) + 1 + h;
  const int n_tiles = static_cast<int>((static_cast<int64_t>(n) + T - 1) / T);
  if (n_tiles == 0) return static_cast<int>(cudaMemsetAsync(out, 0, p_size * sizeof(float), stream));
  if (grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = bwd_smem_bytes<R, T>(h);
  cudaError_t err = cudaFuncSetAttribute(siren_bwd_kernel<R, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  siren_bwd_kernel<R, T><<<grid, h, smem, stream>>>(
      x, cot, cot_stride, n, n_tiles, w1, b1, wh, wht, bh, n_mm, wl, w0, ww, h,
      ws_carry, ws_m, partial, p_size);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned rgrid = static_cast<unsigned>((p_size + 255) / 256);
  siren_reduce_kernel<<<rgrid, 256, 0, stream>>>(partial, grid, p_size, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dudf
