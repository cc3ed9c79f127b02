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
}  // namespace ullava
