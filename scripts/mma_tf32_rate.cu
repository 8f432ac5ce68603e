// The rate of mma.sync.m16n8k8 TF32 on one GPU, the ceiling of the 3xTF32
// products of K2 and K3b (diffudf_tpu_torch/csrc/siren_bwd.cuh):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//       -o diffudf_tpu_torch/_build/mma_tf32_rate scripts/mma_tf32_rate.cu
//   diffudf_tpu_torch/_build/mma_tf32_rate
//
// 1. Register-only: every warp runs CH independent accumulator chains on
//    fixed operands, for 8 or 16 warps an SM.
// 2. W-bar's inner loop: wbar_kernel's 64 x 32 warp tile fed from shared
//    memory by ldmatrix (hi and lo parts already split), 3xTF32 products,
//    with and without the promotion of each two-k-step partial into
//    separate float32 registers; no loads from device memory.
// Prints TF32 TFLOP/s (each mma.sync m16n8k8 is 2 * 16 * 8 * 8 FLOP).

#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldm(uint32_t* r, const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

template <int CH>
__global__ void chains(float* out, int iters) {
  float d[CH][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b0 = threadIdx.x * 3, b1 = threadIdx.x * 5;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CH; ++c) mma(d[c], a, b0, b1);
  }
  float s = 0.0f;
  for (int c = 0; c < CH; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

constexpr int kLd = 36;  // wbar_kernel's row stride
constexpr int kRowsSm = 64;

template <bool PROMOTE>
__global__ void __launch_bounds__(256, 1) wbar_loop(float* out, int iters) {
  __shared__ float sm[4][kRowsSm * kLd];  // C hi, C lo, M-bar hi, M-bar lo
  for (int i = threadIdx.x; i < 4 * kRowsSm * kLd; i += blockDim.x) (&sm[0][0])[i] = (i % 7) * 0.25f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wi = warp >> 2, wj = warp & 3;
  float acc[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t bh[2][4][2], bl[2][4][2];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int at = ((32 * wj + 16 * np + (lane & 7) + ((lane >> 4) << 3)) & (kRowsSm - 1)) * kLd +
                         16 * half + 8 * ks + ((lane >> 3) & 1) * 4;
          uint32_t r[4];
          ldm(r, sm[2] + at);
          bh[ks][2 * np][0] = r[0], bh[ks][2 * np][1] = r[1];
          bh[ks][2 * np + 1][0] = r[2], bh[ks][2 * np + 1][1] = r[3];
          ldm(r, sm[3] + at);
          bl[ks][2 * np][0] = r[0], bl[ks][2 * np][1] = r[1];
          bl[ks][2 * np + 1][0] = r[2], bl[ks][2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        float tmp[4][4] = {};
        float(*d)[4] = PROMOTE ? tmp : acc[mt];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int at = ((64 * wi + 16 * mt + (lane & 15)) & (kRowsSm - 1)) * kLd + 16 * half +
                         8 * ks + (lane >> 4) * 4;
          uint32_t ah[4], al[4];
          ldm(ah, sm[0] + at);
          ldm(al, sm[1] + at);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma(d[u], al, bh[ks][u][0], bh[ks][u][1]);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma(d[u], ah, bl[ks][u][0], bl[ks][u][1]);
#pragma unroll
          for (int u = 0; u < 4; ++u) mma(d[u], ah, bh[ks][u][0], bh[ks][u][1]);
        }
        if (PROMOTE) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[mt][u][c] += tmp[u][c];
          }
        }
      }
    }
  }
  float s = 0.0f;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b)
      for (int c = 0; c < 4; ++c) s += acc[a][b][c];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename K>
void time_it(const char* what, K kernel, int blocks, int threads, int iters, double mmas_per_iter,
             float* out) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  kernel<<<blocks, threads>>>(out, 16);
  cudaEventRecord(e0);
  kernel<<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = mmas_per_iter * iters * 2.0 * 16 * 8 * 8;
  printf("%s: %.3f ms, %.1f TFLOP/s TF32 (%s)\n", what, ms, flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out = nullptr;
  cudaMalloc(&out, static_cast<size_t>(sms) * 4 * 512 * sizeof(float));
  const double warps8 = sms * 8.0, warps16 = sms * 16.0;
  time_it("registers, 4 chains, 8 warps an SM", chains<4>, sms, 256, 4096, warps8 * 4, out);
  time_it("registers, 16 chains, 8 warps an SM", chains<16>, sms, 256, 4096, warps8 * 16, out);
  time_it("registers, 8 chains, 16 warps an SM", chains<8>, sms, 512, 4096, warps16 * 8, out);
  time_it("W-bar loop from shared memory, promoted", wbar_loop<true>, sms, 256, 2000,
          warps8 * 192, out);
  time_it("W-bar loop from shared memory, not promoted", wbar_loop<false>, sms, 256, 2000,
          warps8 * 192, out);
  cudaFree(out);
  return 0;
}
