// The bf16 LayerNorm row pass that the weight-only kernels (K10, K12, K13:
// ln_linear_wq.cu, mlp_block_wq.cu) run before their products: the int8
// core's LayerNorm (`i8::load_row`: fp32, one warp a row held in
// registers, C <= 2048), the result rounded to bf16 and written for the
// GEMM to read by TMA.
#pragma once

#include "ln_quant_rows.cuh"

namespace ullava {
namespace wq {

using i8::kRowMaxVec;
using i8::kRowWarps;

__global__ void __launch_bounds__(kRowWarps * 32)
    ln_rows_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                        const bf16* __restrict__ beta, bf16* __restrict__ xn, int rows, int C,
                        float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  float v[kRowMaxVec][8];
  i8::load_row<true>(v, x + static_cast<size_t>(row) * C, gamma, beta, lane, C, eps);
  bf16* orow = xn + static_cast<size_t>(row) * C;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    const int vec = lane + i * 32;
    if (vec < C / 8) store_bf16x8(orow + vec * 8, v[i]);
  }
}

// x [rows, C] bf16 -> xn [rows, C] bf16 = LN(x).
inline int launch_ln_rows_bf16(const bf16* x, const bf16* gamma, const bf16* beta, bf16* xn,
                               int rows, int C, float eps, cudaStream_t stream) {
  if (rows == 0) return 0;
  const int grid = (rows + kRowWarps - 1) / kRowWarps;
  ln_rows_bf16_kernel<<<grid, kRowWarps * 32, 0, stream>>>(x, gamma, beta, xn, rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wq
}  // namespace ullava
