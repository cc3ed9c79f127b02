// Shared by every kernel library of the port: includes, the C export
// macro and the error-string entry the Python loader reads.
//
// Each .cu file builds into its own shared library with a plain C
// interface (nvcc -shared, loaded with ctypes). An entry point launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ULLAVA_EXPORT extern "C" __attribute__((visibility("default")))

ULLAVA_EXPORT const char* ullava_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace ullava {
using bf16 = __nv_bfloat16;

// {registers a thread, shared bytes a block (dynamic + static), local
// (spilled) bytes a thread, blocks an SM} of `kernel` launched with
// `threads` threads and `smem` dynamic shared bytes (its attribute set
// first), from cudaFuncGetAttributes and the occupancy calculator: what
// the `*_attrs` entries report.
template <class Kernel>
inline int func_attrs(Kernel* kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(smem + a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = blocks;
  return 0;
}

// The current device's SM count, read once: what a grid that walks its
// rows in a loop is sized by.
inline int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;  // an H100 SXM
  }
  return n;
}
}  // namespace ullava
