// Building blocks of the SIREN kernels on Hopper: the forward kernels K1,
// K3a and K4 (siren_fwd.cuh) and the backward kernels K2 and K3b
// (siren_bwd.cuh) of a uniform-width sine SIREN.  A point's carry is R
// rows of width h, [a; J0; J1; J2] and for R = 10 the packed Hessian
// [H0..H5] (xx, xy, xz, yy, yz, zz); K4 carries a alone (R = 1).  Every
// hidden layer maps a tile of T points' R*T rows through one (R*T, h) x
// (h, h) product followed by elementwise work:
//
//   z = m_a + b,  s, c = sincos(ww z),  d1 = ww c,  d2 = -ww^2 s
//   a' = s,  J'_k = d1 m_Jk,  H'_(ij) = d1 m_H(ij) + d2 m_Ji m_Jj.
//
// The blocks:
//  - Tile<R, T>: the register layout.  A CTA has h threads; warp w keeps
//    carry columns [32w, 32w + 32) of all R*T rows in mma.sync accumulator
//    layout, so a point's R rows of a column sit in one thread and the first
//    layer and the activation (first_layer, activate) are elementwise in
//    registers.
//  - frag_kernel lays W (and, for the backward, W^T) of every hidden layer
//    out in the order of mma.sync's B fragments, once per launch.
//  - stage_tile writes the carry to shared memory split into TF32 hi and lo
//    parts; tile_product (every kernel but K1, whose FP32 FMA product is in
//    siren_fwd.cuh) multiplies it by W as mma.sync.m16n8k8 TF32
//    products, lo*hi + hi*lo + hi*hi (3xTF32: float32 accuracy on the tensor
//    cores), B fragments by cp.async from L2, each partial of kPromote k-steps
//    (two unless the caller asks for one) added into float32 registers (the
//    tensor cores' own float32 sum truncates).
//    K4's bf16 product (mma_bf16) is in siren_fwd.cuh.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sincos.cuh"

namespace dudf {

constexpr int kMaxH = 256;       // threads of a tile kernel = hidden width
constexpr int kPad = 4;          // A-buffer row padding: conflict-free ldmatrix
constexpr int kSmem = 232448;    // shared memory a block can have

// a rounded to TF32 to nearest, ties away from zero, as cvt.rna.tf32.f32
// rounds a finite float (two integer instructions; the cvt is five on sm_90).
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// hi = rna(a), lo = rna(a - hi), as TF32 bit patterns.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// d += a b (d = a b when first).  Not volatile: the compiler may
// interleave independent products.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1,
                                         bool first) {
  if (first) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
  } else {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// d[u] (+)= a b[u] for four 8-column tiles u as lo*hi + hi*lo + hi*hi
// (3xTF32), term by term so that consecutive products are independent.
__device__ __forceinline__ void mma3x4(float (*d)[4], const uint32_t* ah, const uint32_t* al,
                                       const uint32_t (*bh)[2], const uint32_t (*bl)[2],
                                       bool first) {
#pragma unroll
  for (int u = 0; u < 4; ++u) mma_tf32(d[u], al, bh[u][0], bh[u][1], first);
#pragma unroll
  for (int u = 0; u < 4; ++u) mma_tf32(d[u], ah, bl[u][0], bl[u][1], false);
#pragma unroll
  for (int u = 0; u < 4; ++u) mma_tf32(d[u], ah, bh[u][0], bh[u][1], false);
}

// d += a b for bf16 a (16x16, row) and b (16x8, col), float32 d: the bf16
// products of K4 (siren_fwd.cuh, Product::kBf16).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v split into TF32 hi and lo, as floats (their bit patterns).
__device__ __forceinline__ void split4(float4 v, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                   __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                   __uint_as_float(l[3]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16x8 A fragment (or two 8x8 B fragments) of 32-bit values from
// shared memory address s: lane L gives the address of row L % 8 of matrix
// L / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Register layout of the tile kernels.  Row r = q*T + t of the tile (row group q,
// point t); a warp's accumulators acc[(i*4 + u)*4 + c] hold m-tile i (rows
// 16i..16i+15), its u-th 8-column tile, element c: row 16i + 8(c/2) + g,
// column 32 warp + 8u + 2 t4 + c%2, with g = lane / 4 and t4 = lane % 4.
// Thread (g, t4) thus holds points g + 8 th (th < T/8), every q.
template <int R, int T>
struct Tile {
  static_assert(T % 8 == 0 && (R * T) % 16 == 0, "R*T rows in m16 tiles, T in eights");
  static constexpr int RT = R * T;
  static constexpr int MT = RT / 16;
  static constexpr int TH = T / 8;
  // register of (row group q, point g + 8 th, column tile u, column 2 t4 + e)
  __host__ __device__ static constexpr int idx(int q, int th, int u, int e) {
    return ((((q * T + th * 8) >> 4) * 4 + u) * 4) + ((((q * T + th * 8) >> 3) & 1) * 2) + e;
  }
  // the same value among the MT float4 of one column tile: [i][c]
  __host__ __device__ static constexpr int tidx(int q, int th, int e) {
    return (((q * T + th * 8) >> 4) * 4) + ((((q * T + th * 8) >> 3) & 1) * 2) + e;
  }
  // depth of the per-thread B-fragment ring, in k-pairs: as deep as the
  // shared memory left by the A buffer at the widest net allows (3 at R*T =
  // 80 rows, 5 at 64), less 8 KB for the static arrays
  // (the value-only tiles of K4, whose products are bf16, have no such ring)
  static constexpr int kRing = (kSmem - 8192 - 2 * RT * (kMaxH + kPad) * 4) / (kMaxH * 4 * 16);
  // dynamic shared memory: the A buffer's hi and lo parts and the B rings
  static constexpr int smem_bytes(int h) {
    static_assert(kRing >= 2, "no room for the B ring");
    return 2 * RT * (h + kPad) * 4 + h * kRing * 4 * 16;
  }
};

// W (o = 0) and, when n_orient is 2, W^T (o = 1) of every hidden layer in
// B-fragment order: float4 {b0, b1 of k-step 2p; b0, b1 of k-step 2p + 1}
// at [layer][o][k-pair p][8-column tile][lane].
__global__ void frag_kernel(const float* __restrict__ wh, int n_mm, int n_orient, int h,
                            float4* __restrict__ frag) {
  const int kp = h / 16, nt = h / 8;
  const int64_t total = static_cast<int64_t>(n_mm) * n_orient * kp * nt * 32;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int lane = static_cast<int>(i % 32);
    int64_t rest = i / 32;
    const int u = static_cast<int>(rest % nt);
    rest /= nt;
    const int p = static_cast<int>(rest % kp);
    rest /= kp;
    const int o = static_cast<int>(rest % n_orient);
    const int l = static_cast<int>(rest / n_orient);
    const float* w = wh + static_cast<int64_t>(l) * h * h;
    const int n = 8 * u + (lane >> 2), t4 = lane & 3;
    float v[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 16 * p + 8 * (s >> 1) + t4 + 4 * (s & 1);
      v[s] = o == 0 ? w[k * h + n] : w[n * h + k];
    }
    frag[i] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// acc (R*T x 32 columns of this warp) = A (R*T x h, its TF32 hi and lo
// parts in shared memory, row stride lda) times B (h x h, fragments of
// frag_kernel), in 3xTF32, the tensor cores' sum of every kPromote k-steps
// (1 or 2) added into float32.  The lane's fragments of k-pair p + kRing are
// requested into the slot of k-pair p once its products are under way.
template <int MT, int kRing, int kPromote = 2>
__device__ __forceinline__ void tile_product(float* acc, const float* a_hi, const float* a_lo,
                                             int lda, const float4* __restrict__ frag,
                                             float4* ring, int h, int warp, int lane) {
  static_assert(kPromote == 1 || kPromote == 2, "promote every one or two k-steps");
  const int kp = h / 16, nt = h / 8;
  const float4* src = frag + static_cast<int64_t>(4 * warp) * 32 + lane;
  auto fetch = [&](int p) {
    if (p < kp) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cp_async16(ring + ((p % kRing) * 4 + u) * 32, src + (static_cast<int64_t>(p) * nt + u) * 32,
                   true);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int p = 0; p < kRing; ++p) fetch(p);
#pragma unroll
  for (int i = 0; i < MT * 16; ++i) acc[i] = 0.0f;
  // byte addresses of this lane's A row, and of the lo part from the hi
  const uint32_t a_at = smem_addr(a_hi + (lane & 15) * lda + (lane >> 4) * 4);
  const uint32_t lo_off = smem_addr(a_lo) - smem_addr(a_hi);
  for (int p = 0; p < kp; ++p) {
    cp_async_wait<kRing - 1>();
    uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 f = ring[((p % kRing) * 4 + u) * 32];
      split_tf32(f.x, bh[0][u][0], bl[0][u][0]);
      split_tf32(f.y, bh[0][u][1], bl[0][u][1]);
      split_tf32(f.z, bh[1][u][0], bl[1][u][0]);
      split_tf32(f.w, bh[1][u][1], bl[1][u][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float tmp[4][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t ah[4], al[4];
        const uint32_t at = a_at + 4 * (16 * mt * lda + 16 * p + 8 * ks);
        ldmatrix_x4(ah, at);
        ldmatrix_x4(al, at + lo_off);
        mma3x4(tmp, ah, al, bh[ks], bl[ks], ks % kPromote == 0);
        if ((ks + 1) % kPromote == 0) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[(mt * 4 + u) * 4 + c] += tmp[u][c];
          }
        }
      }
    }
    fetch(p + kRing);  // into the slot just read
  }
  cp_async_wait<0>();
}

// The thread's accumulators -> the A buffer (row r, column j), split into
// its TF32 hi and lo parts.
template <int MT>
__device__ __forceinline__ void stage_tile(float* a_hi, float* a_lo, int lda, const float* acc,
                                           int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* c = acc + (i * 4 + u) * 4;
      const int at = (16 * i + g) * lda + 32 * warp + 8 * u + 2 * t4;
      float4 hi, lo;
      split4(make_float4(c[0], c[1], c[2], c[3]), hi, lo);
      *reinterpret_cast<float2*>(a_hi + at) = make_float2(hi.x, hi.y);
      *reinterpret_cast<float2*>(a_hi + at + 8 * lda) = make_float2(hi.z, hi.w);
      *reinterpret_cast<float2*>(a_lo + at) = make_float2(lo.x, lo.y);
      *reinterpret_cast<float2*>(a_lo + at + 8 * lda) = make_float2(lo.z, lo.w);
    }
  }
}

// acc = the first layer's carry of a tile's T points, whose x are xs (3 T
// floats): z = x W1 + b1, then a = sin(w0 z), for R = 1 alone (K4's value
// carry, fast_sin), else with its Jacobian and, for R = 10, its packed
// Hessian.  z rounds as the plain versions' x @ W1 + b1: one FMA chain over
// x's coordinates in order, then the bias (sin(w0 z) amplifies z's rounding
// by w0).
template <int R, int T>
__device__ __forceinline__ void first_layer(float* acc, const float* xs,
                                            const float* __restrict__ w1,
                                            const float* __restrict__ b1, float w0, int h,
                                            int warp, int lane) {
  using L = Tile<R, T>;
  const int g = lane >> 2, t4 = lane & 3;
  const float w0sq = w0 * w0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 32 * warp + 8 * u + 2 * t4 + e;
      const float wa = w1[j], wb = w1[h + j], wc = w1[2 * h + j], bj = b1[j];
#pragma unroll
      for (int th = 0; th < L::TH; ++th) {
        const int t = g + 8 * th;
        const float z = fmaf(xs[3 * t + 2], wc, fmaf(xs[3 * t + 1], wb, xs[3 * t] * wa)) + bj;
        if constexpr (R == 1) {
          acc[L::idx(0, th, u, e)] = fast_sin(w0 * z);
        } else {
          float s, c;
          fast_sincos(w0 * z, &s, &c);
          const float d1 = w0 * c;
          acc[L::idx(0, th, u, e)] = s;
          acc[L::idx(1, th, u, e)] = d1 * wa;
          acc[L::idx(2, th, u, e)] = d1 * wb;
          acc[L::idx(3, th, u, e)] = d1 * wc;
          if constexpr (R == 10) {
            const float d2 = -w0sq * s;
            acc[L::idx(4, th, u, e)] = d2 * (wa * wa);
            acc[L::idx(5, th, u, e)] = d2 * (wa * wb);
            acc[L::idx(6, th, u, e)] = d2 * (wa * wc);
            acc[L::idx(7, th, u, e)] = d2 * (wb * wb);
            acc[L::idx(8, th, u, e)] = d2 * (wb * wc);
            acc[L::idx(9, th, u, e)] = d2 * (wc * wc);
          }
        }
      }
    }
  }
}

// The hidden activation on the product m = acc, in place (b: the layer's
// bias): a' = s (R = 1: fast_sin alone), J' = d1 m_J and, for R = 10,
// H' = d1 m_H + d2 m_Ji m_Jj.
template <int R, int T>
__device__ __forceinline__ void activate(float* acc, const float* __restrict__ b, float ww,
                                         int warp, int lane) {
  using L = Tile<R, T>;
  const int t4 = lane & 3;
  const float wwsq = ww * ww;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 32 * warp + 8 * u + 2 * t4 + e;
      const float bj = b[j];
#pragma unroll
      for (int th = 0; th < L::TH; ++th) {
        if constexpr (R == 1) {
          acc[L::idx(0, th, u, e)] = fast_sin(ww * (acc[L::idx(0, th, u, e)] + bj));
        } else {
          float s, c;
          fast_sincos(ww * (acc[L::idx(0, th, u, e)] + bj), &s, &c);
          const float d1 = ww * c;
          const float j0 = acc[L::idx(1, th, u, e)], j1 = acc[L::idx(2, th, u, e)],
                      j2 = acc[L::idx(3, th, u, e)];
          acc[L::idx(0, th, u, e)] = s;
          acc[L::idx(1, th, u, e)] = d1 * j0;
          acc[L::idx(2, th, u, e)] = d1 * j1;
          acc[L::idx(3, th, u, e)] = d1 * j2;
          if constexpr (R == 10) {
            const float d2 = -wwsq * s;
            acc[L::idx(4, th, u, e)] = d1 * acc[L::idx(4, th, u, e)] + d2 * (j0 * j0);
            acc[L::idx(5, th, u, e)] = d1 * acc[L::idx(5, th, u, e)] + d2 * (j0 * j1);
            acc[L::idx(6, th, u, e)] = d1 * acc[L::idx(6, th, u, e)] + d2 * (j0 * j2);
            acc[L::idx(7, th, u, e)] = d1 * acc[L::idx(7, th, u, e)] + d2 * (j1 * j1);
            acc[L::idx(8, th, u, e)] = d1 * acc[L::idx(8, th, u, e)] + d2 * (j1 * j2);
            acc[L::idx(9, th, u, e)] = d1 * acc[L::idx(9, th, u, e)] + d2 * (j2 * j2);
          }
        }
      }
    }
  }
}

}  // namespace dudf
