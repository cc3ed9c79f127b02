// fused_rotary: rotate-half rotary embedding over flat [R, H*hd] rows.
//
// Replaces: ullava_tpu/ops/rope.py:95 fused_rotary (Pallas, one VMEM pass
// with two lane rolls and a half mask).
//
// Bound on the card: bytes. Per element it reads x (2 B) and writes the
// output (2 B), plus one fp32 cos/sin row per token shared by all heads;
// about 3 flops per element, far below the H100's 295 flops/byte ridge.
//
// Design: one thread owns two adjacent rotation pairs (j, j+1) and
// (j+half, j+half+1) of one head of one row, so every load and store is a
// bf16x2 / float2 access and a warp touches contiguous lanes of a row.
// The rotation partner is read from the same row (no roll needed), math
// is fp32 and only the result is rounded to bf16, as on the TPU, which
// also ignores `rope_f32` and always computes in fp32.
#include "common.cuh"

namespace ullava {

__global__ void rope_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ cos_t,
                            const float* __restrict__ sin_t,
                            bf16* __restrict__ out, int rows, int width,
                            int head_dim) {
  const int half = head_dim / 2;
  const int quads_per_head = half / 2;
  const int quads_per_row = width / 4;
  const long long total = static_cast<long long>(rows) * quads_per_row;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(idx / quads_per_row);
    const int quad = static_cast<int>(idx % quads_per_row);
    const int head = quad / quads_per_head;
    const int j = (quad % quads_per_head) * 2;
    const long long base = static_cast<long long>(row) * width +
                           static_cast<long long>(head) * head_dim;
    const float2 x1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + base + j));
    const float2 x2 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + base + j + half));
    const long long tb = static_cast<long long>(row) * head_dim;
    const float2 c1 = *reinterpret_cast<const float2*>(cos_t + tb + j);
    const float2 c2 = *reinterpret_cast<const float2*>(cos_t + tb + j + half);
    const float2 s1 = *reinterpret_cast<const float2*>(sin_t + tb + j);
    const float2 s2 = *reinterpret_cast<const float2*>(sin_t + tb + j + half);
    const float2 lo = make_float2(x1.x * c1.x + (-x2.x) * s1.x,
                                  x1.y * c1.y + (-x2.y) * s1.y);
    const float2 hi = make_float2(x2.x * c2.x + x1.x * s2.x,
                                  x2.y * c2.y + x1.y * s2.y);
    *reinterpret_cast<__nv_bfloat162*>(out + base + j) = __float22bfloat162_rn(lo);
    *reinterpret_cast<__nv_bfloat162*>(out + base + j + half) =
        __float22bfloat162_rn(hi);
  }
}

}  // namespace ullava

// x, out: [rows, width] bf16; cos, sin: [rows, head_dim] fp32.
// width % head_dim == 0, head_dim % 4 == 0 (checked by the wrapper).
ULLAVA_EXPORT int ullava_fused_rotary(const void* x, const void* cos_t,
                                      const void* sin_t, void* out, int rows,
                                      int width, int head_dim, void* stream) {
  const long long quads = static_cast<long long>(rows) * (width / 4);
  const int threads = 256;
  long long blocks = (quads + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  ullava::rope_kernel<<<static_cast<int>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ullava::bf16*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<ullava::bf16*>(out), rows,
      width, head_dim);
  return static_cast<int>(cudaGetLastError());
}
