// Helpers shared by the kernels' C entry points.
#pragma once

#include <cuda_runtime.h>

// Blocks for a grid-stride loop over n items: enough to cover n, at most
// `per_sm` resident blocks on each streaming multiprocessor.
static inline int grid_for(long long n, int threads, int per_sm = 8) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = (n + threads - 1) / threads;
  long long cap = (long long)sms * per_sm;
  return (int)(want < cap ? want : cap);
}
