// Shared helpers for the port's kernels. Plain C interface, no PyTorch
// headers: every entry point takes raw device pointers and a cudaStream_t
// passed as void*, launches on that stream, and returns cudaGetLastError()
// so the ctypes wrapper can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#define DDSP_API extern "C" __attribute__((visibility("default")))

// Return the first launch error (a refused launch never runs, and a later
// synchronize would not report it).
#define DDSP_CHECK_LAUNCH()                     \
  do {                                          \
    cudaError_t err_ = cudaGetLastError();      \
    if (err_ != cudaSuccess) return (int)err_;  \
  } while (0)

__device__ __forceinline__ float ddsp_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}
