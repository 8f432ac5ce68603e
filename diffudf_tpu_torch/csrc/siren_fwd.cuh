// The forward kernel of the SIREN kernels for Hopper: K1 (R = 10, f, grad f
// and the packed Hessian, csrc/vgh.cu), K3a (R = 4, f and grad f,
// csrc/vg.cu) and K4 (R = 1, f alone, csrc/value.cu).  It replaces
// diffudf_tpu/ops/pallas_vgh.py::_vgh_kernel (R = 10), diffudf_tpu/ops/
// pallas_vg.py::_vg_fwd_kernel (R = 4) and diffudf_tpu/ops/pallas_value.py::
// _value_kernel (R = 1): per point x, the Taylor-mode forward of a
// uniform-width sine SIREN with the R-row carry of siren_tile.cuh, then the
// head (h -> 1) of every row.  Output row n is (f | g | h6 | 6 zeros), 16
// floats, for R = 10, (f | g | 4 zeros), 8 floats, for R = 4 and f for
// R = 1, as the Pallas kernels write them.
//
// What bounds it.  Per point and hidden layer one (R, h) x (h, h) product:
// 9.18 MFLOP a point for K1 at 8x256 and 3.67 for K3a, against 76 and 44
// bytes of input and output.  In FP32 FMA on the CUDA cores that takes
// flop / 67e12 s (1.369 ms for K1 at 9,990 points); on the tensor cores as
// three TF32 products (3xTF32, float32 accuracy) 3 * flop / 495e12 s
// (0.445 ms for K3a at 19,980 points).  The bytes (x, the output and the
// weights once) take a few microseconds at 3.35 TB/s.
//
// The design: fwd_kernel<R, T, P>, a persistent grid of at most one CTA per
// SM, h threads, CTA c walking tiles c, c + G, ... of T points (R*T rows: 80
// for K1, 64 for K3a) in the register layout Tile<R, T>.  Each tile runs
// first_layer, then per hidden layer the product and activate (siren_tile.
// cuh); the head sums each row over the thread's columns, then over the
// four lanes of a row group and, in a fixed order, over the warps through
// shared memory.  The product P is one of two:
//  - Product::kFp32 (K1): fma_product, FP32 FMA on the CUDA cores, every
//    element summed over k = 0, 1, ..., h - 1 in turn from 0, the order of
//    a float32 matrix product that gives each output element one FMA
//    chain, so that K1 rounds as its plain version does (vgh.cu is also
//    built without FMA contraction).  Its h6 rows hold d2 J J terms that
//    the sin(30 m) layers amplify: a float32 sum taken in another order,
//    3xTF32's too, lands further from the plain version than the element
//    tolerance K1 is held to (scripts/fwd_gate_check.py).  W's rows come
//    from L2 through a shared ring; nothing is laid out beforehand.
//  - Product::kTf32x3 (K3a): stage_tile and tile_product, 3xTF32 mma.sync
//    promoted into float32 every two k-steps, the forward recompute of the
//    backward kernels' tile_kernel.  frag_kernel first lays W of every
//    hidden layer out in B-fragment order (one orientation), n_mm h^2
//    floats that stay in L2.
//  - Product::kBf16 (K4's mixed mode): stage_bf16 and bf16_product, the
//    carry rounded to bf16 and multiplied by W's bf16 fragments (laid out
//    once per trace by the wrapper) as mma.sync.m16n8k16 with float32
//    sums.  K4's float32 mode takes kFp32.
// Nothing is allocated and nothing goes through device memory but x, the
// weights, the fragments and the output; no atomics: two launches on the
// same input give the same bits.
//
// Ragged tiles: a point past n gets x = 0 and its output is not written.
// Every width that kernel_io.kernel_spec_ok admits runs (a multiple of 32 up
// to 256), and any depth, n_mm = 0 too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "siren_tile.cuh"

namespace dudf {
namespace fwd {

enum class Product { kFp32, kTf32x3, kBf16 };

constexpr int kChunk = 16;   // W rows a slot of fma_product's ring
constexpr int kStages = 3;   // slots of the ring

// Shared memory of fma_product for MT m16 tiles of rows: thread (g, t4)
// holds the 2 MT rows 8m + g, m < 2 MT, of the tile.  A is staged
// transposed, a k-row of it holding row group g's 2 MT values at g * kMg
// (padded to float4s, so that a thread reads its rows as float4s without
// bank conflicts), then the ring of W rows.
template <int MT>
struct FmaTile {
  static constexpr int kM = 2 * MT;
  static constexpr int kMg = (kM + 3) / 4 * 4;
  static constexpr int kLd = 8 * kMg;  // floats of a k-row of A^T
  static constexpr int smem_bytes(int h) { return 4 * (h * kLd + kStages * kChunk * h); }
};

// The thread's accumulators -> A^T in shared memory: element (row 8m + g,
// column j) at at[j * kLd + g * kMg + m].
template <int MT>
__device__ __forceinline__ void stage_rows(float* at, const float* acc, int warp, int lane) {
  using F = FmaTile<MT>;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 32 * warp + 8 * u + 2 * t4 + e;
        const float* c = acc + (i * 4 + u) * 4 + e;  // rows 16i + g and 16i + 8 + g
        *reinterpret_cast<float2*>(at + j * F::kLd + g * F::kMg + 2 * i) =
            make_float2(c[0], c[2]);
      }
    }
  }
}

// acc (the thread's 2 MT rows by its 8 columns 32 warp + 8u + 2 t4 + e) =
// A (staged by stage_rows) times W (h x h, row-major in device memory), in
// FP32 FMA, each element's terms added in k order onto 0.  The block's h
// threads fill the ring: the chunk of W rows kStages - 1 ahead is requested
// once every thread is done with the slot it goes into.
template <int MT>
__device__ __forceinline__ void fma_product(float* acc, const float* at,
                                            const float* __restrict__ w, float* ring, int h,
                                            int warp, int lane) {
  using F = FmaTile<MT>;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_chunks = h / kChunk, per_chunk = kChunk * h / 4;  // float4s a chunk
  auto fetch = [&](int c) {
    if (c < n_chunks) {
      const float4* src =
          reinterpret_cast<const float4*>(w + static_cast<int64_t>(c) * kChunk * h);
      float4* dst = reinterpret_cast<float4*>(ring + (c % kStages) * kChunk * h);
      for (int i = threadIdx.x; i < per_chunk; i += blockDim.x) cp_async16(dst + i, src + i, true);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) fetch(c);
#pragma unroll
  for (int i = 0; i < MT * 16; ++i) acc[i] = 0.0f;
  const float* a_at = at + g * F::kMg;
  const int col = 32 * warp + 2 * t4;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1
    fetch(c + kStages - 1);
    const float* wc = ring + (c % kStages) * kChunk * h + col;
    const float* ac = a_at + c * kChunk * F::kLd;
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[F::kMg];
#pragma unroll
      for (int m = 0; m < F::kMg; m += 4) {
        const float4 v = *reinterpret_cast<const float4*>(ac + kk * F::kLd + m);
        a[m] = v.x;
        a[m + 1] = v.y;
        a[m + 2] = v.z;
        a[m + 3] = v.w;
      }
      float2 b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) b[u] = *reinterpret_cast<const float2*>(wc + kk * h + 8 * u);
#pragma unroll
      for (int m = 0; m < F::kM; ++m) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* d = acc + ((m >> 1) * 4 + u) * 4 + 2 * (m & 1);
          d[0] = fmaf(a[m], b[u].x, d[0]);
          d[1] = fmaf(a[m], b[u].y, d[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Product::kBf16 (K4's mixed mode): the carry is staged in bf16, rounded
// to nearest even (row r, column j at a[r * (h + kBfPad) + j]; the padding
// makes ldmatrix conflict-free), and W of every hidden layer arrives from
// the wrapper in B-fragment order, laid out once per trace
// (ops/kernel_io.py::value_fragments): uint4 {b0, b1 of k-step 2p; b0, b1
// of k-step 2p + 1} at [layer][k-pair p][8-column tile][lane], two bf16 a
// register.  Each lane streams its warp's fragments from L2 through its
// own kBfRing slots of shared memory (no barrier: a lane reads only what it
// fetched), tile after tile, layer after layer, so the ring never drains
// at a layer's end.
constexpr int kBfPad = 8;   // bf16 elements of A-row padding
constexpr int kBfRing = 8;  // k-pairs in flight a lane (one layer at h = 256)

template <int MT>
struct BfTile {
  static constexpr int smem_bytes(int h) {
    return 2 * MT * 16 * (h + kBfPad) + (h / 32) * kBfRing * 4 * 32 * 16;
  }
};

// A CTA's stream of W fragments through one lane's ring: the k-pairs of
// layer 0, 1, ..., n_mm - 1, once for each of the CTA's tiles.
struct BfStream {
  const uint4* src;  // the fragments, at this lane's entry of its warp's first column tile
  uint4* ring;       // this lane's kBfRing slots, 4 column tiles each, 32 lanes apart
  int nt;            // 8-column tiles a layer
  int per_tile;      // k-pairs of every hidden layer
  int steps;         // k-pairs of every tile of the CTA
  int fetched, used;

  // request the next k-pair into its slot (an empty group past the end)
  __device__ __forceinline__ void fetch() {
    if (fetched < steps) {
      const int s = fetched % per_tile;
      uint4* dst = ring + (fetched % kBfRing) * 4 * 32;
#pragma unroll
      for (int u = 0; u < 4; ++u) cp_async16(dst + u * 32, src + (s * nt + u) * 32, true);
    }
    cp_async_commit();
    ++fetched;
  }
};

// acc (the warp's 32 columns of the RT = 16 MT rows) = A (bf16, staged by
// stage_bf16) times W (bf16 fragments from st), as mma.sync.m16n8k16 with
// float32 sums: each element's k-steps in order, onto 0.  Products of two
// bf16 values are exact in float32.
template <int MT>
__device__ __forceinline__ void bf16_product(float* acc, const __nv_bfloat16* a, int lda,
                                             BfStream& st, int h, int lane) {
  const int kp = h / 32;
#pragma unroll
  for (int i = 0; i < MT * 16; ++i) acc[i] = 0.0f;
  // byte address of this lane's ldmatrix row: row lane % 16, k-half lane / 16
  const uint32_t a_at = smem_addr(a + (lane & 15) * lda + (lane >> 4) * 8);
  for (int p = 0; p < kp; ++p) {
    cp_async_wait<kBfRing - 1>();
    const uint4* slot = st.ring + (st.used % kBfRing) * 4 * 32;
    uint4 b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) b[u] = slot[u * 32];
    ++st.used;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t af[4];
        ldmatrix_x4(af, a_at + 2 * (16 * mt * lda + 32 * p + 16 * ks));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          mma_bf16(acc + (mt * 4 + u) * 4, af, ks ? b[u].z : b[u].x, ks ? b[u].w : b[u].y);
        }
      }
    }
    st.fetch();  // into the slot just read
  }
}

// The thread's accumulators -> the bf16 A buffer (row r, column j), each
// rounded to nearest even, where K4's plain version rounds its operand.
template <int MT>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* a, int lda, const float* acc, int warp,
                                           int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* c = acc + (i * 4 + u) * 4;
      const int at = (16 * i + g) * lda + 32 * warp + 8 * u + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(a + at) = __floats2bfloat162_rn(c[0], c[1]);
      *reinterpret_cast<__nv_bfloat162*>(a + at + 8 * lda) = __floats2bfloat162_rn(c[2], c[3]);
    }
  }
}

// An activation as the head multiplies it: for kBf16 rounded to bf16, so
// that its product with W_L's bf16 value (the wrapper rounds W_L) is exact.
template <Product P>
__device__ __forceinline__ float head_operand(float a) {
  if constexpr (P == Product::kBf16) {
    return __bfloat162float(__float2bfloat16_rn(a));
  } else {
    return a;
  }
}

template <int R, int T, Product P>
constexpr int smem_bytes(int h) {
  if constexpr (P == Product::kFp32) return FmaTile<Tile<R, T>::MT>::smem_bytes(h);
  else if constexpr (P == Product::kBf16) return BfTile<Tile<R, T>::MT>::smem_bytes(h);
  else return Tile<R, T>::smem_bytes(h);
}

template <int R, int T, Product P>
__global__ void __launch_bounds__(kMaxH, 1)
fwd_kernel(const float* __restrict__ x, int n, int n_tiles, const float* __restrict__ w1,
           const float* __restrict__ b1, const float* __restrict__ wsrc,
           const float* __restrict__ bh, int n_mm, const float* __restrict__ wl,
           const float* __restrict__ bl, float w0, float ww, int h, float* __restrict__ out,
           int out_stride) {
  using L = Tile<R, T>;
  constexpr int RT = L::RT, MT = L::MT, TH = L::TH, kRing = L::kRing;
  constexpr int kWarps = kMaxH / 32;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float xs[T * 3];
  __shared__ float part[RT * kWarps];  // part[r * kWarps + w]: warp w's sum of row r

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_warps = blockDim.x >> 5;
  // per hidden layer, W (kFp32: row-major) or its fragments (kTf32x3)
  const int64_t w_layer = static_cast<int64_t>(h) * h;
  float acc[RT];
  // kBf16: this lane's stream of W fragments, started before the first tile
  BfStream st{};
  if constexpr (P == Product::kBf16) {
    const int kp = h / 32;
    st.src = reinterpret_cast<const uint4*>(wsrc) + 4 * warp * 32 + lane;
    st.ring = reinterpret_cast<uint4*>(
                  smem4 + (2 * RT * (h + kBfPad)) / 16) + warp * (kBfRing * 4 * 32) + lane;
    st.nt = h / 8;
    st.per_tile = n_mm * kp;
    st.steps = st.per_tile * ((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x);
    st.fetched = st.used = 0;
#pragma unroll
    for (int i = 0; i < kBfRing; ++i) st.fetch();
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t base = static_cast<int64_t>(tile) * T;
    __syncthreads();  // xs and part are free
    for (int i = tid; i < T * 3; i += blockDim.x) {
      xs[i] = base + i / 3 < n ? x[base * 3 + i] : 0.0f;
    }
    __syncthreads();

    first_layer<R, T>(acc, xs, w1, b1, w0, h, warp, lane);
    for (int l = 0; l < n_mm; ++l) {
      if constexpr (P == Product::kFp32) {
        float* at = smem;  // (h, kLd): A^T
        stage_rows<MT>(at, acc, warp, lane);
        __syncthreads();
        fma_product<MT>(acc, at, wsrc + l * w_layer, at + h * FmaTile<MT>::kLd, h, warp, lane);
      } else if constexpr (P == Product::kBf16) {
        __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(smem);  // (RT, h + kBfPad)
        stage_bf16<MT>(a, h + kBfPad, acc, warp, lane);
        __syncthreads();
        bf16_product<MT>(acc, a, h + kBfPad, st, h, lane);
      } else {
        const int lda = h + kPad;
        float* a_hi = smem;             // (RT, h + kPad): TF32 hi of the carry
        float* a_lo = a_hi + RT * lda;  // and its lo
        // this lane's slots of its warp's ring: [kRing][4][32 lanes] float4
        float4* ring = smem4 + (2 * RT * lda) / 4 + warp * (kRing * 4 * 32) + lane;
        stage_tile<MT>(a_hi, a_lo, lda, acc, warp, lane);
        __syncthreads();
        tile_product<MT, kRing>(acc, a_hi, a_lo, lda,
                                reinterpret_cast<const float4*>(wsrc + l * w_layer), ring, h,
                                warp, lane);
      }
      __syncthreads();  // every warp is done reading this layer's carry
      activate<R, T>(acc, bh + static_cast<int64_t>(l) * h, ww, warp, lane);
    }

    // ---- head: row (q, t) dotted with W_L -----------------------------------
    float v[R * TH];
#pragma unroll
    for (int i = 0; i < R * TH; ++i) v[i] = 0.0f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float wlj = wl[32 * warp + 8 * u + 2 * t4 + e];
#pragma unroll
        for (int q = 0; q < R; ++q) {
#pragma unroll
          for (int th = 0; th < TH; ++th) {
            v[q * TH + th] += head_operand<P>(acc[L::idx(q, th, u, e)]) * wlj;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
#pragma unroll
      for (int th = 0; th < TH; ++th) {
        // the four lanes of row group g hold the warp's 32 columns
        float s = v[q * TH + th];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t4 == 0) part[(q * T + g + 8 * th) * kWarps + warp] = s;
      }
    }
    __syncthreads();
    for (int i = tid; i < T * out_stride; i += blockDim.x) {
      const int t = i / out_stride, q = i % out_stride;  // q: 0 = f, 1..3 = g, then h6
      const int64_t p = base + t;
      if (p >= n) continue;
      float s = 0.0f;
      if (q < R) {
        for (int w = 0; w < n_warps; ++w) s += part[(q * T + t) * kWarps + w];
        if (q == 0) s += bl[0];
      }
      out[p * out_stride + q] = s;
    }
  }
}

// The kernels on `stream`; -> cudaGetLastError() (0 = ok).  x (n, 3); w1
// (3, h); b1 (h); wh (n_mm, h, h); bh (n_mm, h); wl (h); bl (1); grid tile
// CTAs (at most the tiles); frag n_mm h^2 floats of workspace for
// Product::kTf32x3 (unused by kFp32), as ops/kernel_io.py::FwdPlan sizes
// it, and for kBf16 W's n_mm h^2 bf16 fragments, read only (wh is then not
// read); out (n, out_stride).
template <int R, int T, Product P>
int launch(const float* x, int n, const float* w1, const float* b1, const float* wh,
           const float* bh, int n_mm, const float* wl, const float* bl, float w0, float ww,
           int h, int grid, float* frag, float* out, int out_stride, cudaStream_t stream) {
  if (h % 32 != 0 || h > kMaxH || h <= 0 || n < 0 || n_mm < 0 || out_stride < R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = static_cast<int>((static_cast<int64_t>(n) + T - 1) / T);
  if (n_tiles == 0) return 0;
  if (grid <= 0 || grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (P == Product::kTf32x3 && n_mm > 0) {
    frag_kernel<<<264, 256, 0, stream>>>(wh, n_mm, 1, h, reinterpret_cast<float4*>(frag));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = smem_bytes<R, T, P>(h);
  err = cudaFuncSetAttribute(fwd_kernel<R, T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_kernel<R, T, P><<<grid, h, smem, stream>>>(x, n, n_tiles, w1, b1,
                                                 P == Product::kFp32 ? wh : frag, bh, n_mm, wl,
                                                 bl, w0, ww, h, out, out_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fwd
}  // namespace dudf
