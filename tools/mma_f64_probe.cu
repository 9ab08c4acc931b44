// The FP64 mma.sync shapes on one Hopper card: fragment layouts and rates.
// The evidence behind K1's choice of m16n8k4 (PERF.md), run by hand; no
// check or entry point builds it.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_f64_probe \
//       tools/mma_f64_probe.cu && build/mma_f64_probe
//
// For m8n8k4 (sm_80 and later) and the sm_90 shapes m16n8k4, m16n8k8 and
// m16n8k16 it checks one product against the host (the fragment layouts K1,
// csrc/pairpanel_spmm.cu, relies on) and prints the rate of 264 CTAs of
// 4 and 8 warps, each warp issuing products into 8 independent
// accumulators.  g = lane / 4, t = lane % 4; A element i of a thread sits
// at row g + 8*(i % 2), column t + 4*(i / 2) (m8n8k4: row g, column t); B
// element i at row t + 4*i, column g; D element i at row g + 8*(i / 2),
// column 2*t + i % 2.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdio>
#include <vector>

template <int S>
struct Shape;
template <> struct Shape<0> { static constexpr int M = 8, N = 8, K = 4, NA = 1, NB = 1, NC = 2; };
template <> struct Shape<1> { static constexpr int M = 16, N = 8, K = 4, NA = 2, NB = 1, NC = 4; };
template <> struct Shape<2> { static constexpr int M = 16, N = 8, K = 8, NA = 4, NB = 2, NC = 4; };
template <> struct Shape<3> { static constexpr int M = 16, N = 8, K = 16, NA = 8, NB = 4, NC = 4; };

template <int S>
__device__ __forceinline__ void mma(double* d, const double* a, const double* b) {
  if constexpr (S == 0) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                 : "+d"(d[0]), "+d"(d[1]) : "d"(a[0]), "d"(b[0]));
  } else if constexpr (S == 1) {
    asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a[0]), "d"(a[1]), "d"(b[0]));
  } else if constexpr (S == 2) {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
  } else {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
                 "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
                 : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
                 : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
                   "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
}

template <int S>
__global__ void layout_kernel(const double* A, const double* B, double* D) {
  using Sh = Shape<S>;
  const int g = threadIdx.x >> 2, t = threadIdx.x & 3;
  double a[Sh::NA], b[Sh::NB], d[Sh::NC];
  for (int i = 0; i < Sh::NA; ++i)
    a[i] = S == 0 ? A[g * Sh::K + t] : A[(g + 8 * (i % 2)) * Sh::K + t + 4 * (i / 2)];
  for (int i = 0; i < Sh::NB; ++i) b[i] = B[(t + 4 * i) * Sh::N + g];
  for (int i = 0; i < Sh::NC; ++i) d[i] = 0.0;
  mma<S>(d, a, b);
  for (int i = 0; i < Sh::NC; ++i) D[(g + 8 * (i / 2)) * Sh::N + 2 * t + i % 2] = d[i];
}

template <int S>
__global__ void rate_kernel(double* out, int iters) {
  using Sh = Shape<S>;
  double a[Sh::NA], b[Sh::NB], d[8][Sh::NC];
  for (int i = 0; i < Sh::NA; ++i) a[i] = 1e-3 * (threadIdx.x + i);
  for (int i = 0; i < Sh::NB; ++i) b[i] = 1e-3 * (threadIdx.x - i);
  for (int f = 0; f < 8; ++f)
    for (int i = 0; i < Sh::NC; ++i) d[f][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int f = 0; f < 8; ++f) mma<S>(d[f], a, b);
  }
  double s = 0;
  for (int f = 0; f < 8; ++f)
    for (int i = 0; i < Sh::NC; ++i) s += d[f][i];
  if (s == 12345.678) out[0] = s;  // keeps the products alive
}

template <int S>
bool run(const char* name) {
  using Sh = Shape<S>;
  std::vector<double> A(Sh::M * Sh::K), B(Sh::K * Sh::N), D(Sh::M * Sh::N), R(Sh::M * Sh::N, 0.0);
  for (size_t i = 0; i < A.size(); ++i) A[i] = std::cos(1.0 + i);
  for (size_t i = 0; i < B.size(); ++i) B[i] = std::sin(2.0 + i);
  for (int i = 0; i < Sh::M; ++i)
    for (int j = 0; j < Sh::N; ++j)
      for (int k = 0; k < Sh::K; ++k) R[i * Sh::N + j] += A[i * Sh::K + k] * B[k * Sh::N + j];
  double *dA, *dB, *dD, *dout;
  cudaMalloc(&dA, A.size() * 8);
  cudaMalloc(&dB, B.size() * 8);
  cudaMalloc(&dD, D.size() * 8);
  cudaMalloc(&dout, 8);
  cudaMemcpy(dA, A.data(), A.size() * 8, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, B.data(), B.size() * 8, cudaMemcpyHostToDevice);
  layout_kernel<S><<<1, 32>>>(dA, dB, dD);
  const cudaError_t e = cudaDeviceSynchronize();
  cudaMemcpy(D.data(), dD, D.size() * 8, cudaMemcpyDeviceToHost);
  double err = 0;
  for (size_t i = 0; i < D.size(); ++i) err = std::fmax(err, std::fabs(D[i] - R[i]));
  const bool ok = e == cudaSuccess && err < 1e-12;
  std::printf("%s: layout %s (maxerr %.3e, %s)\n", name, ok ? "ok" : "WRONG", err, cudaGetErrorString(e));
  const int iters = 20000, ctas = 264;
  for (int warps : {4, 8}) {
    rate_kernel<S><<<ctas, 32 * warps>>>(dout, 10);
    cudaEvent_t t0, t1;
    cudaEventCreate(&t0);
    cudaEventCreate(&t1);
    cudaEventRecord(t0);
    rate_kernel<S><<<ctas, 32 * warps>>>(dout, iters);
    cudaEventRecord(t1);
    cudaEventSynchronize(t1);
    float ms = 0;
    cudaEventElapsedTime(&ms, t0, t1);
    const double flops = 2.0 * Sh::M * Sh::N * Sh::K * 8.0 * iters * ctas * warps;
    std::printf("%s: %d CTAs of %d warps: %.2f TFlop/s (%s)\n", name, ctas, warps, flops / ms / 1e9,
                cudaGetErrorString(cudaGetLastError()));
  }
  cudaFree(dA);
  cudaFree(dB);
  cudaFree(dD);
  cudaFree(dout);
  return ok;
}

int main() {
  bool ok = run<0>("m8n8k4");
  ok = run<1>("m16n8k4") && ok;
  ok = run<2>("m16n8k8") && ok;
  ok = run<3>("m16n8k16") && ok;
  return ok ? 0 : 1;
}
