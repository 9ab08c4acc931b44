// The launch counters of the port's kernels (launch_counts.py).  Every
// kernel entry takes a pointer to its 64-bit counter on the card, or null,
// and the kernel adds one to it from block 0's thread 0 whenever it runs:
// inside a CUDA graph too, where the host never sees a launch, so the
// counters say how often each kernel ran, not how often it was called.

#pragma once

__device__ __forceinline__ void count_launch(unsigned long long* count) {
  if (count != nullptr && threadIdx.x == 0 && threadIdx.y == 0 &&
      threadIdx.z == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0)
    atomicAdd(count, 1ULL);
}
