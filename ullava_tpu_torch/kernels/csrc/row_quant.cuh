// Helpers of the one-block-per-row kernels (rms_quant.cu,
// silu_mul_quant.cu): 16-byte bf16 vector access, block reductions (also
// used by decode_attention_int8.cu) and the int8 row store (both also used
// by the row pass of ln_quant_rows.cuh, and the vector access by
// rms_norm_bwd.cu).
//
// A row of n floats is staged in dynamic shared memory, followed by 32
// floats of reduction scratch (`row_smem_bytes`). Thread t owns the
// 8-element vectors t, t + blockDim.x, ... in every pass over the row, so
// passes need no barrier between them beyond the reductions' own.
#pragma once

#include "common.cuh"

namespace ullava {

constexpr int kRowThreads = 256;

inline size_t row_smem_bytes(int n) { return (static_cast<size_t>(n) + 32) * sizeof(float); }

// 8 bf16 values as loaded in one 16-byte word -> 8 floats.
__device__ inline void unpack_bf16x8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// 8 contiguous bf16 values (16 bytes) -> 8 floats.
__device__ inline void load_bf16x8(const bf16* p, float (&f)[8]) {
  unpack_bf16x8(*reinterpret_cast<const uint4*>(p), f);
}

// 8 floats -> 8 contiguous bf16 values, round to nearest even.
__device__ inline void store_bf16x8(bf16* p, const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// 8 floats, each times `s`, rounded half to even -> 8 contiguous int8.
__device__ inline void store_int8x8(int8_t* p, const float* f, float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = __float2int_rn(f[i] * s);
    w[i / 4] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * (i % 4));
  }
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

template <bool kMax>
__device__ inline float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

// Sum (or max) of `v` over the block, returned to every thread.
// `scratch` holds 32 floats; safe to call again right after it returns.
template <bool kMax>
__device__ inline float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  __syncthreads();  // the scratch of an earlier call has been read
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  // Lanes past the last warp add nothing: 0 to a sum, a repeat to a max.
  v = lane < warps ? scratch[lane] : (kMax ? scratch[0] : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace ullava
