// silu_mul_quant: silu(gate) * up, quantized per row to int8.
//
// Replaces: ullava_tpu/ops/mlp_kernel.py:390 silu_mul_quant (kernel
// _silu_mul_quant_kernel, :381; blocks of up to 256 rows through VMEM).
//
// Bound on the card: bytes. Per element it reads gate and up (2 B each)
// and writes one int8: 5 B for one exp, one divide and a few multiplies.
//
// Design: one block of 256 threads per row. Pass 1 loads gate and up as
// 16-byte vectors, forms g * sigmoid(g) * u in fp32 (expf, not the fast
// intrinsic, so the abs-max agrees with the plain version), stages the
// fp32 row in shared memory and takes the abs-max; after one block
// reduction pass 2 rounds half to even into int8. The gated row never
// reaches device memory in fp32 or bf16. The width need not be a power of
// two (11008 = 1376 vectors): the vector loop strides by the block size
// and its bound is the row's own vector count.
#include "row_quant.cuh"

namespace ullava {

__global__ void __launch_bounds__(kRowThreads)
silu_mul_quant_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                      int8_t* __restrict__ q_out, float* __restrict__ amax_out,
                      int F) {
  extern __shared__ float smem[];
  float* row = smem;
  float* scratch = smem + F;
  const long long base = static_cast<long long>(blockIdx.x) * F;
  const int vecs = F / 8;

  float am = 0.f;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    float g[8], u[8];
    load_bf16x8(gate + base + v * 8, g);
    load_bf16x8(up + base + v * 8, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sig = 1.0f / (1.0f + expf(-g[i]));
      const float h = g[i] * sig * u[i];
      row[v * 8 + i] = h;
      am = fmaxf(am, fabsf(h));
    }
  }
  const float amax = fmaxf(block_reduce<true>(am, scratch), 1e-12f);
  const float s = 127.0f / amax;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x)
    store_int8x8(q_out + base + v * 8, row + v * 8, s);
  if (threadIdx.x == 0) amax_out[blockIdx.x] = amax;
}

}  // namespace ullava

// gate, up: [rows, F] bf16; q_out: [rows, F] int8; amax_out: [rows] f32.
// F % 8 == 0 and (F + 32) * 4 <= 48 KB (checked by the wrapper).
ULLAVA_EXPORT int ullava_silu_mul_quant(const void* gate, const void* up,
                                        void* q_out, void* amax_out, int rows,
                                        int F, void* stream) {
  if (rows > 0)
    ullava::silu_mul_quant_kernel<<<rows, ullava::kRowThreads,
                                    ullava::row_smem_bytes(F),
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const ullava::bf16*>(gate), static_cast<const ullava::bf16*>(up),
        static_cast<int8_t*>(q_out), static_cast<float*>(amax_out), F);
  return static_cast<int>(cudaGetLastError());
}
