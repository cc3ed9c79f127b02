// The row pass of the int8 products (LayerNorm + per-row symmetric int8
// quantization, `launch_ln_quant_rows`) that K10, K12 and K13 run before
// their products on the wgmma + TMA int8 core (int8_gemm_sm90.cuh) and K23
// before its one kernel (mlp_block_v2_int8.cu), and the fp32 LayerNorm of
// a row held in a warp's registers (`load_row`) that the weight-only
// kernels' bf16 row pass (ln_rows_bf16.cuh) shares.
#pragma once

#include "row_quant.cuh"

namespace ullava {
namespace i8 {

// Row pass: optional LayerNorm (fp32 mean, biased variance, rsqrt, scale,
// bias) and per-row symmetric int8 quantization, one warp per row. The
// row (C <= 2048 bf16 values) is held in registers.
//   xs[row] = max(amax, 1e-12) / 127,  xq = rn(v * (127 / max(amax, 1e-12)))
// The LN products are kept unfused (no FMA) so that a row quantizes as
// the plain version's separate multiply and add do.
constexpr int kRowMaxVec = 8;  // 8 x 32 lanes x 8 values = 2048 columns
constexpr int kRowWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Loads row `xr` into a lane's registers (vectors lane, lane + 32, ...
// of the row's C / 8) and, with LN, replaces it by its LayerNorm in fp32.
template <bool LN>
__device__ __forceinline__ void load_row(float (&v)[kRowMaxVec][8], const bf16* __restrict__ xr,
                                         const bf16* __restrict__ gamma,
                                         const bf16* __restrict__ beta, int lane, int C,
                                         float eps) {
  const int nv = C / 8;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    const int vec = lane + i * 32;
    if (vec < nv) {
      load_bf16x8(xr + vec * 8, v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[i][j];
    }
  }
  if (!LN) return;
  const float mean = warp_sum(sum) / static_cast<float>(C);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    if (lane + i * 32 < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] -= mean;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(C) + eps);
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    const int vec = lane + i * 32;
    if (vec < nv) {
      float gm[8], bt[8];
      load_bf16x8(gamma + vec * 8, gm);
      load_bf16x8(beta + vec * 8, bt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], rstd), gm[j]), bt[j]);
    }
  }
}

template <bool LN>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_quant_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                         const bf16* __restrict__ beta, int8_t* __restrict__ xq,
                         float* __restrict__ xs, int rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int nv = C / 8;
  float v[kRowMaxVec][8];
  load_row<LN>(v, x + static_cast<size_t>(row) * C, gamma, beta, lane, C, eps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    if (lane + i * 32 < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  amax = fmaxf(warp_max(amax), 1e-12f);
  const float qs = 127.0f / amax;
  if (lane == 0) xs[row] = amax * (1.0f / 127.0f);
  int8_t* qr = xq + static_cast<size_t>(row) * C;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    const int vec = lane + i * 32;
    if (vec < nv) store_int8x8(qr + vec * 8, v[i], qs);
  }
}

// x [rows, C] bf16 -> xq [rows, C] int8, xs [rows] f32; gamma == nullptr
// skips the LayerNorm.
inline int launch_ln_quant_rows(const bf16* x, const bf16* gamma, const bf16* beta, int8_t* xq,
                                float* xs, int rows, int C, float eps, cudaStream_t stream) {
  if (rows == 0) return 0;
  const int grid = (rows + kRowWarps - 1) / kRowWarps;
  if (gamma != nullptr)
    ln_quant_rows_kernel<true><<<grid, kRowWarps * 32, 0, stream>>>(x, gamma, beta, xq, xs, rows,
                                                                     C, eps);
  else
    ln_quant_rows_kernel<false><<<grid, kRowWarps * 32, 0, stream>>>(x, gamma, beta, xq, xs, rows,
                                                                      C, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace i8
}  // namespace ullava
