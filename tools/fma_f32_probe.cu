// The FP32 FMA rate one Hopper card sustains outside the tensor cores: from
// registers alone, and from shared memory with the load pattern of the
// complex micro-tile of K2 and K3 (csrc/panel_stage.cuh) and no global
// copies.  The evidence behind PERF.md's FP32 ceiling and the choice of the
// micro-tile, run by hand; no check or entry point builds it.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/fma_f32_probe \
//       tools/fma_f32_probe.cu && build/fma_f32_probe
//
// Registers: every thread runs 64 independent FMA chains (the 4 x 4 complex
// micro-tile's accumulators) on operands it holds.  Shared memory: a CTA of
// 16 x 16 threads multiplies one resident stage [KC = 16] over and over, one
// barrier a stage as the kernels' ring has; thread (ty, tx) reads its TM
// rows of the A slice (re and im) and its TN lanes of the X rows (re and im)
// for every depth step and does 4*TM*TN FMAs on them.  Rates count 2 flops
// an FMA.  Prints each kernel's registers and CTAs per SM beside its rate.

#include <cuda_runtime.h>

#include <cstdio>

constexpr int kThreads = 256;
constexpr int KC = 16;

__global__ void __launch_bounds__(kThreads)
regs_kernel(float* out, int iters) {
  float acc[64];
  float a[4], b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = 1e-3f * (threadIdx.x + i);
    b[i] = 1.f - 1e-6f * (threadIdx.x + i);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      acc[i] = fmaf(a[i % 4], b[(i / 4) % 4], acc[i]);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += acc[i];
  if (s == 12345.678f) out[0] = s;  // keeps the chains alive
}

template <int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
smem_kernel(float* out, int iters) {
  constexpr int BM = 16 * TM, BN = 16 * TN;
  // [A re | A im] rows of 2*BM and [X re | X im] rows of 2*BN, two stages
  __shared__ __align__(16) float smem[2][KC * (2 * BM + 2 * BN)];
  for (int e = threadIdx.x; e < 2 * KC * (2 * BM + 2 * BN); e += kThreads)
    (&smem[0][0])[e] = 1e-3f * (e % 97);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc_re[TM][TN], acc_im[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc_re[m][n] = acc_im[m][n] = 0.f;
  for (int it = 0; it < iters; ++it) {
    __syncthreads();
    const float* s_a = smem[it & 1];
    const float* s_x = s_a + KC * 2 * BM;
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      float ar[TM], ai[TM], xr[TN], xi[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        ar[m] = s_a[q * 2 * BM + ty * TM + m];
        ai[m] = s_a[q * 2 * BM + BM + ty * TM + m];
      }
#pragma unroll
      for (int n = 0; n < TN; ++n) {
        xr[n] = s_x[q * 2 * BN + tx * TN + n];
        xi[n] = s_x[q * 2 * BN + BN + tx * TN + n];
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) {
          acc_re[m][n] = fmaf(ar[m], xr[n], acc_re[m][n]);
          acc_re[m][n] = fmaf(-ai[m], xi[n], acc_re[m][n]);
          acc_im[m][n] = fmaf(ar[m], xi[n], acc_im[m][n]);
          acc_im[m][n] = fmaf(ai[m], xr[n], acc_im[m][n]);
        }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) s += acc_re[m][n] + acc_im[m][n];
  if (s == 12345.678f) out[0] = s;
}

template <class K>
void time_kernel(const char* name, K kernel, double flops_per_cta_iter,
                 float* dout) {
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kernel);
  int occ = 0, dev = 0, nsm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, 0);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  const int iters = 4000;
  for (int per_sm = 1; per_sm <= occ && per_sm <= 4; ++per_sm) {
    const int ctas = per_sm * nsm;
    kernel<<<ctas, kThreads>>>(dout, 10);
    cudaEvent_t t0, t1;
    cudaEventCreate(&t0);
    cudaEventCreate(&t1);
    cudaEventRecord(t0);
    kernel<<<ctas, kThreads>>>(dout, iters);
    cudaEventRecord(t1);
    cudaEventSynchronize(t1);
    float ms = 0;
    cudaEventElapsedTime(&ms, t0, t1);
    std::printf("%s: %d registers, %zu B spilled, %d CTAs an SM of %d: "
                "%.2f TFlop/s (%s)\n", name, attr.numRegs,
                attr.localSizeBytes, per_sm, occ,
                flops_per_cta_iter * iters * ctas / ms / 1e9,
                cudaGetErrorString(cudaGetLastError()));
    cudaEventDestroy(t0);
    cudaEventDestroy(t1);
  }
}

template <int TM, int TN>
void time_smem(const char* name, float* dout) {
  time_kernel(name, smem_kernel<TM, TN>,
              8.0 * TM * TN * KC * kThreads, dout);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  std::printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
  float* dout;
  cudaMalloc(&dout, 4);
  time_kernel("registers, 64 chains", regs_kernel, 2.0 * 64 * kThreads, dout);
  time_smem<4, 4>("shared memory, 4 x 4 complex", dout);
  time_smem<8, 4>("shared memory, 8 x 4 complex", dout);
  time_smem<4, 8>("shared memory, 4 x 8 complex", dout);
  time_smem<4, 2>("shared memory, 4 x 2 complex", dout);
  time_smem<4, 1>("shared memory, 4 x 1 complex", dout);
  time_smem<2, 2>("shared memory, 2 x 2 complex", dout);
  cudaFree(dout);
  return cudaDeviceSynchronize() == cudaSuccess ? 0 : 1;
}
