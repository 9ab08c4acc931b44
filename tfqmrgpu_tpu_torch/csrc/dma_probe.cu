// Device-memory -> shared-memory stream probe on Hopper (sm_90a), FP32:
//
//   out[rows, 128] = sum over ops, steps of x[op, step, :, :128]
//
// for x of shape [n_ops, nsteps, rows, cols].  It replaces the TPU probe K4,
// tools/dma_probe.py::kernel, which streamed every [rows, cols] block of
// n_ops operands through the grid pipeline into VMEM and accumulated one
// 128-column slice, so that the copy, not the arithmetic, is what is timed.
//
// Design: every byte of every block is copied into shared memory with
// cp.async (16 bytes a thread per instruction, L1 bypassed), in stages of
// `stage_bytes` (each operand's share of a stage is stage_bytes / n_ops)
// and two stages in flight: the CTA starts copying stage n+1, then waits
// for stage n and adds the slice elements that stage holds.  Each thread
// owns rows*128/256 fixed outputs in registers.  CTA b walks the steps b,
// b + grid, ... and writes its partial sums to scratch; a second kernel
// adds the partials of all CTAs in a fixed order, so the result has the
// same bits every run.
//
// What bounds it: device memory.  The probe reads every operand byte once
// (1 GiB per variant, far beyond the 50 MB L2) and does one add per element
// of the slice, an eighth of the elements at cols = 1024; the scratch pass
// adds grid*rows*128*4 bytes (about 1-3% of the stream).  Its rate over the
// card's 3.35 TB/s is the device-memory ceiling the port's bounds are read
// against.  Left for later: TMA bulk copies with mbarriers in place of
// cp.async, and a persistent grid sized from a measured sweep.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 128;  // the accumulated column slice
constexpr int kMaxOwned = 32;  // outputs per thread: rows <= 64

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ x, int n_ops, long long op_stride,
              int nsteps, int rows, int cols, int chunk,
              float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];  // [2][n_ops][chunk]
  const int tid = threadIdx.x;
  const int block_elems = rows * cols;
  const int chunks_per_step = (block_elems + chunk - 1) / chunk;
  const int owned = rows * kSlice / kThreads;

  int flat[kMaxOwned];
  float acc[kMaxOwned];
#pragma unroll
  for (int k = 0; k < kMaxOwned; ++k) {
    const int p = tid + k * kThreads;  // output (p / 128, p % 128)
    flat[k] = (p / kSlice) * cols + p % kSlice;
    acc[k] = 0.f;
  }

  // the CTA's sequence of stages: (step, chunk) for steps b, b + grid, ...
  const long long b = blockIdx.x, grid = gridDim.x;
  const long long my_steps = b < nsteps ? (nsteps - 1 - b) / grid + 1 : 0;
  const long long nstages = my_steps * chunks_per_step;

  auto fetch = [&](long long n) {
    const long long step = b + (n / chunks_per_step) * grid;
    const int f0 = static_cast<int>(n % chunks_per_step) * chunk;
    const int len = min(chunk, block_elems - f0);
    float* buf = smem + (n & 1) * static_cast<size_t>(n_ops) * chunk;
    for (int op = 0; op < n_ops; ++op) {
      const float* src = x + op * op_stride + step * block_elems + f0;
      float* dst = buf + static_cast<size_t>(op) * chunk;
      for (int e = tid * 4; e < len; e += kThreads * 4)
        cp_async16(dst + e, src + e);
    }
    cp_async_commit();
  };

  if (nstages > 0) fetch(0);
  for (long long n = 0; n < nstages; ++n) {
    if (n + 1 < nstages) {
      fetch(n + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int f0 = static_cast<int>(n % chunks_per_step) * chunk;
    const int len = min(chunk, block_elems - f0);
    const float* buf = smem + (n & 1) * static_cast<size_t>(n_ops) * chunk;
    for (int op = 0; op < n_ops; ++op) {
      const float* src = buf + static_cast<size_t>(op) * chunk;
#pragma unroll
      for (int k = 0; k < kMaxOwned; ++k) {
        const int off = flat[k] - f0;
        if (k < owned && off >= 0 && off < len) acc[k] += src[off];
      }
    }
    __syncthreads();  // the buffer is refilled two stages later
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * rows * kSlice;
#pragma unroll
  for (int k = 0; k < kMaxOwned; ++k)
    if (k < owned) out[tid + k * kThreads] = acc[k];
}

__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, int nparts, int n,
              float* __restrict__ out) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  float s = 0.f;
  for (int b = 0; b < nparts; ++b) s += partial[static_cast<size_t>(b) * n + p];
  out[p] = s;
}

size_t smem_bytes(int chunk, int n_ops) {
  return 2 * static_cast<size_t>(n_ops) * chunk * sizeof(float);
}

}  // namespace

// The number of CTAs (one wave) the probe launches for a stage of
// stage_bytes over n_ops operands, or a negative cudaError_t.
extern "C" int tfq_dma_probe_ctas(int stage_bytes, int n_ops) {
  if (n_ops <= 0 || stage_bytes <= 0 || stage_bytes % (16 * n_ops) != 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int chunk = stage_bytes / 4 / n_ops;
  const size_t smem = smem_bytes(chunk, n_ops);
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_kernel,
                                                      kThreads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return per_sm * sms;
}

// x: [n_ops, nsteps, rows, cols] f32, contiguous, 16-byte aligned;
// partial: [ctas, rows, 128] scratch; out: [rows, 128].  Two launches on
// `stream`; returns the cudaError_t (0 on success).
extern "C" int tfq_dma_probe_f32(const void* x, int n_ops, int nsteps,
                                 int rows, int cols, int stage_bytes,
                                 int ctas, void* partial, void* out,
                                 void* stream) {
  if (n_ops <= 0 || nsteps <= 0 || rows <= 0 || ctas <= 0 ||
      rows * kSlice > kThreads * kMaxOwned || rows * kSlice % kThreads != 0 ||
      cols < kSlice || cols % 4 != 0 ||
      stage_bytes % (16 * n_ops) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = stage_bytes / 4 / n_ops;
  const size_t smem = smem_bytes(chunk, n_ops);
  cudaError_t err = cudaFuncSetAttribute(
      stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const long long op_stride = static_cast<long long>(nsteps) * rows * cols;
  stream_kernel<<<ctas, kThreads, smem, s>>>(
      static_cast<const float*>(x), n_ops, op_stride, nsteps, rows, cols,
      chunk, static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = rows * kSlice;
  reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(partial), ctas, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
