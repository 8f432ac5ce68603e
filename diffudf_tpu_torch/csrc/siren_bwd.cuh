// The backward kernel of the SIREN training kernels for Hopper: K2 (R = 10,
// the VJP of f, grad f and the packed Hessian, csrc/vgh_bwd.cu) and K3b
// (R = 4, the VJP of f and grad f, csrc/vg.cu).  It replaces
// diffudf_tpu/ops/pallas_vgh_vjp.py::_vgh_bwd_kernel (R = 10) and
// diffudf_tpu/ops/pallas_vg.py::_vg_bwd_kernel (R = 4), term for term: the
// gradient of sum(cot * outputs) with respect to every W and b of a
// uniform-width sine SIREN, written flat in the ravel_pytree layout (per
// layer b then w).  A point's carry is R rows, [a; J0; J1; J2] and for
// R = 10 the packed Hessian [H0..H5] (xx, xy, xz, yy, yz, zz).
//
// What bounds it.  Per point and hidden layer it runs three (R, h) x (h, h)
// products: the forward recompute m = carry W, the weight gradient
// W-bar += carry^T m-bar and the carry's cotangent m-bar W^T (27.5 MFLOP a
// point for K2 at 8x256, 11.0 for K3b).  On CUDA cores in FP32 FMA that is
// 4.105 ms for K2 at 9,990 points and 3.284 ms for K3b at 19,980; as three
// TF32 tensor-core products each (below) it is 1.667 and 1.334 ms.  The
// inputs are 76 and 44 bytes a point, so the operations bound it, unless
// the residuals and the weight gradient go through device memory once per
// tile: at 1,249 tiles that alone was about 7 GB a launch (2 ms at 3.35
// TB/s) in the design this one replaced.
//
// The design: four kernels on one stream.
//  1. frag_kernel lays W (for m = carry W) and W^T (for carrybar = m-bar
//     W^T) out once per launch in the order of mma.sync's B fragments:
//     float4 {b0, b1 of k-step 2p; b0, b1 of k-step 2p + 1} per (layer,
//     k-pair p, 8-column tile, lane), 2 n_mm h^2 floats that stay in L2.
//     No transposed copy of the weights is made outside the launch.
//  2. tile_kernel<R, T>: a persistent grid of at most one CTA per SM, h
//     threads, CTA c walking tiles c, c + G, ... of T points (R*T rows: 80
//     for K2, 64 for K3b).  Warp w owns carry columns [32w, 32w + 32) and
//     keeps all R*T rows of them in mma accumulator layout, so a point's R
//     rows of a column sit in one thread and the activation, its backward
//     and the first layer are elementwise in registers.  Each product is
//     mma.sync.m16n8k8 TF32 with float32 operands split into a TF32 high and
//     low part (hi = rna(a), lo = rna(a - hi), rounded to nearest with
//     ties away as cvt.rna.tf32.f32 rounds, in two integer instructions)
//     and summed as lo*hi + hi*lo + hi*hi: float32 accuracy on tensor cores
//     (3xTF32).  The A operand (carry or m-bar, R*T x h) is staged in
//     shared memory already split, hi and lo, and read with ldmatrix; the B
//     fragments stream from L2 through a per-thread cp.async ring (3 k-pairs
//     deep for K2, 5 for K3b: what shared memory leaves).  Every two k-steps
//     the tensor-core sum is added into a float32 register accumulator
//     (promotion): the tensor cores' own float32 sum truncates, and without
//     it the kernel's distance from float64 grew six- to thirteenfold.  The
//     forward writes each product's input carry (C, for step 3) and its
//     result m (to a per-CTA workspace of n_mm R*T h floats, reused by every
//     tile) once; the backward reads m back, forms m-bar, writes it once
//     (M-bar, for step 3) and runs m-bar W^T.  The small gradients (b1, W1,
//     b_L, W_L) are summed per CTA in shared memory and written once per CTA.
//  3. wbar_kernel: W-bar_l = C_l^T M-bar_l and b-bar_l = the sum of M-bar_l's
//     value rows, split over K = R*T*n_tiles rows.  C and M-bar are stored in
//     blocks of 32 rows, each block column by column ([K/32][h][32]), so a
//     CTA's chunk of 32 rows of 128 columns is 16 KB in one run.  A CTA takes
//     one 128 x 128 block of one layer over one run of rows (33 runs a layer
//     at the training shapes: seven full waves); its chunks come in by
//     cp.async four deep and its warps split their ldmatrix fragments in
//     registers, in the same 3xTF32 arithmetic promoted every two k-steps.
//     It writes its partial once.
//  4. reduce_kernel adds the partials of steps 2 and 3 in a fixed order
//     (blocks of 16, then the block sums) into the flat gradient.
// No float atomics anywhere: two launches on the same input give the same
// bits.  Bytes a launch (ops/kernel_io.py::BwdPlan.bytes_moved): C, M-bar
// and m are each written once and read once, n_mm R*T h floats a tile:
// 6 x 0.716 GB for K2 at 9,990 points, 6 x 0.573 GB for K3b at 19,980, plus
// the W-bar partials (0.12 GB at 33 runs); 4.43 and 3.57 GB, 1.32 and 1.07
// ms at 3.35 TB/s, below the 3xTF32 operations bound.  On an H100 at 700 W
// K2 takes about 5.3 ms and K3b 4.6 (PERF.md): the tile kernel idles the
// tensor cores through its elementwise layers and barriers, and the W-bar
// kernel spends as many instructions splitting operands as multiplying.
//
// Ragged tiles: a point past n gets x = 0 and a zero cotangent, which makes
// every term it adds zero.  Every width that kernel_io.kernel_spec_ok
// admits runs (a multiple of 32 up to 256), and any depth, n_mm = 0 too.
//
// The blocks it shares with the forward kernels K1 and K3a (the register
// layout, the fragments, the 3xTF32 product, the first layer and the
// activation) are in siren_tile.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "siren_tile.cuh"

namespace dudf {
namespace bwd {

constexpr int kBlk = 128;        // wbar_kernel's output block, rows and columns
constexpr int kChunk = 32;       // wbar_kernel's rows of K per pipeline stage
constexpr int kLd2 = kChunk + 4; // its smem row stride: conflict-free ldmatrix
constexpr int kStages2 = 4;      // its cp.async pipeline depth
constexpr int kReduceBlock = 16;

// Floats of the per-CTA small gradients: b1 (h), W1 (3h), b_L (1), W_L (h).
__host__ __device__ constexpr int small_size(int h) { return 5 * h + 1; }

// Layout of C and M-bar, per layer: blocks of 32 rows of K, each block
// column by column ([K/32][h][32]), so that a block's rows of any 128
// columns are one contiguous run for wbar_kernel.
__host__ __device__ __forceinline__ int64_t kblock_at(int64_t k, int64_t col, int h) {
  return (k >> 5) * (32 * static_cast<int64_t>(h)) + col * 32 + (k & 31);
}
__host__ __device__ __forceinline__ int64_t kblock_rows(int64_t k_rows) {
  return (k_rows + 31) & ~static_cast<int64_t>(31);
}

// The thread's accumulators -> rows base..base+RT-1 of a layer's C or M-bar.
template <int MT>
__device__ __forceinline__ void store_columns(float* __restrict__ buf, int h, int64_t base,
                                              const float* acc, int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t j = 32 * warp + 8 * u + 2 * t4 + (c & 1);
        buf[kblock_at(base + 16 * i + 8 * (c >> 1) + g, j, h)] = acc[(i * 4 + u) * 4 + c];
      }
    }
  }
}

// Sum over the eight lanes of a column group (lanes with the same t4).
__device__ __forceinline__ float sum_g(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

template <int R, int T>
__global__ void __launch_bounds__(kMaxH, 1)
tile_kernel(const float* __restrict__ x, const float* __restrict__ cot, int cot_stride, int n,
            int n_tiles, const float* __restrict__ w1, const float* __restrict__ b1,
            const float4* __restrict__ frag, const float* __restrict__ bh, int n_mm,
            const float* __restrict__ wl, float w0, float ww, int h,
            float* __restrict__ ws_m, float* __restrict__ cbuf, float* __restrict__ mbar,
            float* __restrict__ small) {
  using L = Tile<R, T>;
  constexpr int RT = L::RT, MT = L::MT, TH = L::TH;
  extern __shared__ float4 smem4[];
  const int lda = h + kPad;
  float* a_hi = reinterpret_cast<float*>(smem4);  // (RT, h + kPad): TF32 hi of A
  float* a_lo = a_hi + RT * lda;                  // and its lo
  __shared__ float xs[T * 3];
  __shared__ float cs[T * R];  // cs[t * R + q]: the cotangent of row group q
  __shared__ float s_small[small_size(kMaxH)];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  constexpr int kRing = L::kRing;
  // this lane's slots of its warp's ring: [kRing][4][32 lanes] float4
  float4* ring = smem4 + (2 * RT * lda) / 4 + warp * (kRing * 4 * 32) + lane;
  const int64_t c_layer = kblock_rows(static_cast<int64_t>(n_tiles) * RT) * h;  // C, M-bar
  const int64_t layer_block = static_cast<int64_t>(RT) * h;  // floats of m per layer
  const int64_t frag_layer = static_cast<int64_t>(h) * h / 4;  // float4s per orientation
  float* my_m = ws_m + static_cast<int64_t>(blockIdx.x) * n_mm * layer_block;
  const float wwsq = ww * ww, w0sq = w0 * w0;
  float* s_b1 = s_small;
  float* s_w1 = s_small + h;
  float* s_bl = s_small + 4 * h;
  float* s_wl = s_small + 4 * h + 1;
  for (int i = tid; i < small_size(h); i += blockDim.x) s_small[i] = 0.0f;

  float acc[RT];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t base = static_cast<int64_t>(tile) * T;
    __syncthreads();  // xs, cs and s_small are free
    for (int i = tid; i < T * 3; i += blockDim.x) {
      xs[i] = base + i / 3 < n ? x[base * 3 + i] : 0.0f;
    }
    for (int i = tid; i < T * R; i += blockDim.x) {
      const int64_t p = base + i / R;
      cs[i] = p < n ? cot[p * cot_stride + i % R] : 0.0f;
    }
    __syncthreads();

    first_layer<R, T>(acc, xs, w1, b1, w0, h, warp, lane);

    // ---- forward recompute: C_l out, m_l to the workspace ----------------
    for (int l = 0; l < n_mm; ++l) {
      store_columns<MT>(cbuf + l * c_layer, h, static_cast<int64_t>(tile) * RT, acc, warp, lane);
      stage_tile<MT>(a_hi, a_lo, lda, acc, warp, lane);
      __syncthreads();
      tile_product<MT, kRing>(acc, a_hi, a_lo, lda, frag + (2 * l) * frag_layer, ring, h, warp,
                              lane);
      __syncthreads();  // every warp is done reading this layer's carry
      float4* mdst = reinterpret_cast<float4*>(my_m + l * layer_block);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* c = acc + (i * 4 + u) * 4;
          mdst[(i * (h / 8) + 4 * warp + u) * 32 + lane] = make_float4(c[0], c[1], c[2], c[3]);
        }
      }
      activate<R, T>(acc, bh + static_cast<int64_t>(l) * h, ww, warp, lane);
    }

    // ---- head: W_L-bar, b_L-bar, and the carry's cotangent ---------------
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 32 * warp + 8 * u + 2 * t4 + e;
        const float wlj = wl[j];
        float gsum = 0.0f;
#pragma unroll
        for (int q = 0; q < R; ++q) {
#pragma unroll
          for (int th = 0; th < TH; ++th) {
            const int t = g + 8 * th;
            gsum = fmaf(cs[t * R + q], acc[L::idx(q, th, u, e)], gsum);
            acc[L::idx(q, th, u, e)] = cs[t * R + q] * wlj;
          }
        }
        gsum = sum_g(gsum);
        if (g == 0) s_wl[j] += gsum;
      }
    }
    if (tid == 0) {
      float fb = 0.0f;
      for (int t = 0; t < T; ++t) fb += cs[t * R];
      *s_bl += fb;
    }

    // ---- hidden layers, last to first: m-bar out, carrybar = m-bar W^T ----
    for (int l = n_mm - 1; l >= 0; --l) {
      const float4* msrc = reinterpret_cast<const float4*>(my_m + l * layer_block);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float mz[MT * 4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float4 v = msrc[(i * (h / 8) + 4 * warp + u) * 32 + lane];
          mz[i * 4 + 0] = v.x;
          mz[i * 4 + 1] = v.y;
          mz[i * 4 + 2] = v.z;
          mz[i * 4 + 3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 32 * warp + 8 * u + 2 * t4 + e;
          const float bj = bh[static_cast<int64_t>(l) * h + j];
#pragma unroll
          for (int th = 0; th < TH; ++th) {
#define MZ(q) mz[L::tidx(q, th, e)]
            float s, c;
            fast_sincos(ww * (MZ(0) + bj), &s, &c);
            const float d1 = ww * c;
            const float d2 = -wwsq * s;
            const float jz0 = MZ(1), jz1 = MZ(2), jz2 = MZ(3);
            const float ab = acc[L::idx(0, th, u, e)];
            const float jb0 = acc[L::idx(1, th, u, e)], jb1 = acc[L::idx(2, th, u, e)],
                        jb2 = acc[L::idx(3, th, u, e)];
            const float sum_j = jb0 * jz0 + jb1 * jz1 + jb2 * jz2;
            float zbar;
            if constexpr (R == 10) {
              float hz[6], hb[6];
#pragma unroll
              for (int q = 0; q < 6; ++q) {
                hz[q] = MZ(4 + q);
                hb[q] = acc[L::idx(4 + q, th, u, e)];
              }
              float sum_h = 0.0f;
#pragma unroll
              for (int q = 0; q < 6; ++q) sum_h += hb[q] * hz[q];
              const float sum_o = hb[0] * (jz0 * jz0) + hb[1] * (jz0 * jz1) +
                                  hb[2] * (jz0 * jz2) + hb[3] * (jz1 * jz1) +
                                  hb[4] * (jz1 * jz2) + hb[5] * (jz2 * jz2);
              zbar = d1 * ab + d2 * (sum_j + sum_h) - wwsq * d1 * sum_o;
              acc[L::idx(1, th, u, e)] = d1 * jb0 + d2 * (2.0f * hb[0] * jz0 + hb[1] * jz1 + hb[2] * jz2);
              acc[L::idx(2, th, u, e)] = d1 * jb1 + d2 * (hb[1] * jz0 + 2.0f * hb[3] * jz1 + hb[4] * jz2);
              acc[L::idx(3, th, u, e)] = d1 * jb2 + d2 * (hb[2] * jz0 + hb[4] * jz1 + 2.0f * hb[5] * jz2);
#pragma unroll
              for (int q = 0; q < 6; ++q) acc[L::idx(4 + q, th, u, e)] = d1 * hb[q];
            } else {
              zbar = d1 * ab + d2 * sum_j;
              acc[L::idx(1, th, u, e)] = d1 * jb0;
              acc[L::idx(2, th, u, e)] = d1 * jb1;
              acc[L::idx(3, th, u, e)] = d1 * jb2;
            }
            acc[L::idx(0, th, u, e)] = zbar;
#undef MZ
          }
        }
      }
      store_columns<MT>(mbar + l * c_layer, h, static_cast<int64_t>(tile) * RT, acc, warp, lane);
      stage_tile<MT>(a_hi, a_lo, lda, acc, warp, lane);
      __syncthreads();
      tile_product<MT, kRing>(acc, a_hi, a_lo, lda, frag + (2 * l + 1) * frag_layer, ring, h,
                              warp, lane);
      __syncthreads();  // the A buffer is free again
    }

    // ---- first layer, with the direct dependence of J1 and H1 on W1 ------
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
          const float z = xs[3 * t] * wa + xs[3 * t + 1] * wb + xs[3 * t + 2] * wc + bj;
          float s, c;
          fast_sincos(w0 * z, &s, &c);
          const float d1 = w0 * c;
          const float d2 = -w0sq * s;
          const float ab = acc[L::idx(0, th, u, e)];
          const float jb0 = acc[L::idx(1, th, u, e)], jb1 = acc[L::idx(2, th, u, e)],
                      jb2 = acc[L::idx(3, th, u, e)];
          float zbar = d1 * ab + d2 * (jb0 * wa + jb1 * wb + jb2 * wc);
          float e0 = jb0 * d1, e1 = jb1 * d1, e2 = jb2 * d1;  // direct terms
          if constexpr (R == 10) {
            const float hb0 = acc[L::idx(4, th, u, e)], hb1 = acc[L::idx(5, th, u, e)],
                        hb2 = acc[L::idx(6, th, u, e)], hb3 = acc[L::idx(7, th, u, e)],
                        hb4 = acc[L::idx(8, th, u, e)], hb5 = acc[L::idx(9, th, u, e)];
            const float sum_hw = hb0 * (wa * wa) + hb1 * (wa * wb) + hb2 * (wa * wc) +
                                 hb3 * (wb * wb) + hb4 * (wb * wc) + hb5 * (wc * wc);
            zbar -= w0sq * d1 * sum_hw;
            e0 += d2 * (2.0f * hb0 * wa + hb1 * wb + hb2 * wc);
            e1 += d2 * (hb1 * wa + 2.0f * hb3 * wb + hb4 * wc);
            e2 += d2 * (hb2 * wa + hb4 * wb + 2.0f * hb5 * wc);
          }
          zs += zbar;
          g0 += xs[3 * t] * zbar + e0;
          g1 += xs[3 * t + 1] * zbar + e1;
          g2 += xs[3 * t + 2] * zbar + e2;
        }
        zs = sum_g(zs);
        g0 = sum_g(g0);
        g1 = sum_g(g1);
        g2 = sum_g(g2);
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
  float* out = small + static_cast<int64_t>(blockIdx.x) * small_size(h);
  for (int i = tid; i < small_size(h); i += blockDim.x) out[i] = s_small[i];
}

// W-bar_l block (blockIdx.x) over rows
// [s*split_rows, (s+1)*split_rows) of K (s = blockIdx.y), l = blockIdx.z;
// CTAs of the first row block also sum M-bar_l's value rows (row % RT < T)
// into b-bar_l.  Out: wpart[l][s] = (h*h W-bar | h b-bar).  Chunks of 32
// rows come in by cp.async, kStages2 deep, and the warps split their
// fragments into TF32 hi and lo in registers: shared memory carries each
// value once.
__global__ void __launch_bounds__(256, 1)
wbar_kernel(const float* __restrict__ cbuf, const float* __restrict__ mbar, int h,
            int64_t k_rows, int rt, int t_pts, int64_t split_rows, float* __restrict__ wpart) {
  constexpr int kWr = kBlk / 2, kMt = kWr / 16;  // a warp's rows and m-tiles
  constexpr int kStage = 2 * kBlk * kLd2;        // floats of one stage: C, then M-bar
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);  // [stage][C | M-bar rows][kLd2]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nb = (h + kBlk - 1) / kBlk;
  const int ib = blockIdx.x / nb, jb = blockIdx.x % nb;
  const int i0 = ib * kBlk, j0 = jb * kBlk;
  const int l = blockIdx.z, s = blockIdx.y, n_split = gridDim.y;
  const int64_t kbeg = s * split_rows;
  const int64_t kend = kbeg + split_rows < k_rows ? kbeg + split_rows : k_rows;
  const int n_chunks = kend > kbeg ? static_cast<int>((kend - kbeg + kChunk - 1) / kChunk) : 0;
  const int64_t c_layer = kblock_rows(k_rows) * h;

  // This thread's pieces: columns 4 seg..4 seg+3 of rows row0 + 32 q of the
  // C tile (q < kQc) and then of the M-bar tile.
  const int seg = tid & 7, row0 = tid >> 3;
  constexpr int kQc = kBlk / 32, kQ = 2 * kQc;
  const float* src[kQ];
  bool live[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const bool is_c = q < kQc;
    const int col = (is_c ? i0 + 32 * q : j0 + 32 * (q - kQc)) + row0;
    live[q] = col < h;
    src[q] = (is_c ? cbuf : mbar) + l * c_layer + kblock_at(kbeg + 4 * seg, live[q] ? col : 0, h);
  }
  auto fetch = [&](int chunk) {
    if (chunk < n_chunks) {
      const int64_t step = static_cast<int64_t>(chunk) * kChunk * h;  // chunk-th block
      const bool in = kbeg + static_cast<int64_t>(chunk) * kChunk + 4 * seg < kend;
      float* dst = raw + (chunk % kStages2) * kStage + row0 * kLd2 + 4 * seg;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const bool valid = in && live[q];
        cp_async16(dst + 32 * q * kLd2, valid ? src[q] + step : src[q], valid);
      }
    }
    cp_async_commit();
  };

  const int wi = warp >> 2, wj = warp & 3;  // this warp: rows kWr wi, columns 32 wj
  const bool busy = i0 + kWr * wi < h && j0 + 32 * wj < h;
  // the first row block's warps of the first row sum the value rows of
  // M-bar's columns 32 wj + 8 u + g from their B fragments
  const bool bias = ib == 0 && wi == 0 && busy;
  float acc[kMt][4][4];
#pragma unroll
  for (int a = 0; a < kMt; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.0f;
  float bsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  // this lane's rows in a stage's C and M-bar tiles (byte offsets)
  const uint32_t c_at = 4 * ((kWr * wi + (lane & 15)) * kLd2 + (lane >> 4) * 4);
  const uint32_t m_at = 4 * ((kBlk + 32 * wj + (lane & 7) + ((lane >> 4) << 3)) * kLd2 +
                             ((lane >> 3) & 1) * 4);
  const uint32_t raw_at = smem_addr(raw);
#pragma unroll
  for (int c = 0; c < kStages2 - 1; ++c) fetch(c);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<kStages2 - 2>();
    __syncthreads();  // the chunk is in; the stage before it is free
    fetch(chunk + kStages2 - 1);
    if (!busy) continue;
    const uint32_t st = raw_at + 4 * (chunk % kStages2) * kStage;
    // row of its tile of the lane's first B-fragment row of K in this chunk
    const int r0 = bias ? static_cast<int>((kbeg + static_cast<int64_t>(chunk) * kChunk + t4) % rt) : 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, st + m_at + 4 * (16 * np * kLd2 + 16 * half + 8 * ks));
          split_tf32(__uint_as_float(r[0]), bh[ks][2 * np][0], bl[ks][2 * np][0]);
          split_tf32(__uint_as_float(r[1]), bh[ks][2 * np][1], bl[ks][2 * np][1]);
          split_tf32(__uint_as_float(r[2]), bh[ks][2 * np + 1][0], bl[ks][2 * np + 1][0]);
          split_tf32(__uint_as_float(r[3]), bh[ks][2 * np + 1][1], bl[ks][2 * np + 1][1]);
          if (bias) {  // b0 holds row k + t4, b1 row k + t4 + 4 (zero past kend)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              int rr = r0 + 16 * half + 8 * ks + 4 * e;
              rr = rr < rt ? rr : rr - rt;
              if (rr < t_pts) {
                bsum[2 * np] += __uint_as_float(r[e]);
                bsum[2 * np + 1] += __uint_as_float(r[2 + e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        float tmp[4][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[4], ah[4], al[4];
          ldmatrix_x4(a, st + c_at + 4 * (16 * mt * kLd2 + 16 * half + 8 * ks));
#pragma unroll
          for (int c = 0; c < 4; ++c) split_tf32(__uint_as_float(a[c]), ah[c], al[c]);
          mma3x4(tmp, ah, al, bh[ks], bl[ks], ks == 0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][u][c] += tmp[u][c];
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = wpart + (static_cast<int64_t>(l) * n_split + s) * (static_cast<int64_t>(h) * h + h);
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + kWr * wi + 16 * mt + g + 8 * (c >> 1);
        const int j = j0 + 32 * wj + 8 * u + 2 * t4 + (c & 1);
        if (i < h && j < h) out[static_cast<int64_t>(i) * h + j] = acc[mt][u][c];
      }
    }
  }
  if (bias) {
    // a column's rows of K sit in the four lanes 4g..4g+3: add them in order
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float v = bsum[u];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      const int j = j0 + 32 * wj + 8 * u + g;
      if (t4 == 0 && j < h) out[static_cast<int64_t>(h) * h + j] = v;
    }
  }
}

// out[e] = the sum of element e's partials in a fixed order: blocks of
// kReduceBlock in order, then the block sums in order.  The small gradients
// (b1, W1, b_L, W_L) come from g1 per-CTA partials of tile_kernel, every
// hidden layer's b and W from n_split partials of wbar_kernel.
__global__ void reduce_kernel(const float* __restrict__ small, int g1,
                              const float* __restrict__ wpart, int n_split, int h, int n_mm,
                              float* __restrict__ out) {
  const int64_t hh = static_cast<int64_t>(h) * h;
  const int64_t hidden = static_cast<int64_t>(n_mm) * (h + hh);
  const int64_t p_size = 4 * static_cast<int64_t>(h) + hidden + 1 + h;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= p_size) return;
  const float* src;
  int64_t stride;
  int count;
  if (e < 4 * h || e >= 4 * h + hidden) {
    // b1 and W1 sit at [0, 4h) of a small partial, b_L and W_L at [4h, 5h+1)
    src = small + (e < 4 * h ? e : e - hidden);
    stride = small_size(h);
    count = g1;
  } else {
    const int64_t o = e - 4 * h;
    const int64_t l = o / (h + hh), r = o % (h + hh);
    src = wpart + l * n_split * (hh + h) + (r < h ? hh + r : r - h);
    stride = hh + h;
    count = n_split;
  }
  float s = 0.0f;
  for (int c0 = 0; c0 < count; c0 += kReduceBlock) {
    const int c1 = c0 + kReduceBlock < count ? c0 + kReduceBlock : count;
    float b = 0.0f;
    for (int c = c0; c < c1; ++c) b += src[c * stride];
    s += b;
  }
  out[e] = s;
}

// The four kernels on `stream`; -> cudaGetLastError() (0 = ok).  Sizes (in
// floats) as ops/kernel_io.py::BwdPlan.sizes sets them: frag 2 n_mm h^2,
// ws_m grid n_mm R*T h, cbuf and mbar n_mm h K32 (K = R*T ceil(n / T) rows,
// K32 = K rounded up to 32), small grid (5h + 1), wpart n_mm n_split
// (h^2 + h), out the flat gradient.
template <int R, int T>
int launch(const float* x, const float* cot, int cot_stride, int n, const float* w1,
           const float* b1, const float* wh, const float* bh, int n_mm, const float* wl,
           float w0, float ww, int h, int grid, int n_split, int64_t split_rows, float* frag,
           float* ws_m, float* cbuf, float* mbar, float* small, float* wpart, float* out,
           cudaStream_t stream) {
  using L = Tile<R, T>;
  if (h % 32 != 0 || h > kMaxH || h <= 0 || n < 0 || n_mm < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t p_size = 4 * static_cast<int64_t>(h) +
                         static_cast<int64_t>(n_mm) * (h + static_cast<int64_t>(h) * h) + 1 + h;
  const int n_tiles = static_cast<int>((static_cast<int64_t>(n) + T - 1) / T);
  if (n_tiles == 0) return static_cast<int>(cudaMemsetAsync(out, 0, p_size * sizeof(float), stream));
  const int64_t k_rows = static_cast<int64_t>(n_tiles) * L::RT;
  if (grid <= 0 || grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  if (n_mm > 0 && (n_split <= 0 || split_rows % kChunk != 0 ||
                   static_cast<int64_t>(n_split) * split_rows < k_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (n_mm > 0) {
    frag_kernel<<<264, 256, 0, stream>>>(wh, n_mm, 2, h, reinterpret_cast<float4*>(frag));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const int smem1 = L::smem_bytes(h);
  err = cudaFuncSetAttribute(tile_kernel<R, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_kernel<R, T><<<grid, h, smem1, stream>>>(
      x, cot, cot_stride, n, n_tiles, w1, b1, reinterpret_cast<const float4*>(frag), bh, n_mm, wl,
      w0, ww, h, ws_m, cbuf, mbar, small);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_mm > 0) {
    const int smem2 = kStages2 * 2 * kBlk * kLd2 * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(wbar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nb = (h + kBlk - 1) / kBlk;
    wbar_kernel<<<dim3(nb * nb, n_split, n_mm), 256, smem2, stream>>>(
        cbuf, mbar, h, k_rows, L::RT, T, split_rows, wpart);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned rgrid = static_cast<unsigned>((p_size + 255) / 256);
  reduce_kernel<<<rgrid, 256, 0, stream>>>(small, grid, wpart, n_split, h, n_mm, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace dudf
