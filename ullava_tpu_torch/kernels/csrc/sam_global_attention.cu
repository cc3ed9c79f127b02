// fused_global_attention: SAM ViT global-block attention over the 64 x 64
// grid (S = 4096, hd 80) with the decomposed rel-pos bias, online softmax.
//
// Replaces: ullava_tpu/ops/sam_attention.py:490 fused_global_attention
// (Pallas, transpose-staged [B*H, S, hd] layout, tiled flash).
//
// Bound on the card: at ViT-H B=4 (N = 64 instances) a layer does
// 64*4096*4096*80*4 = 344 GFLOP of products, ~0.35 ms at 989 TFLOP/s
// bf16, against ~0.2 GB of HBM traffic (~0.06 ms): operations bound it.
//
// Design: the shared online-softmax core (flash_core.cuh), one block per
// (instance, 64-row q tile), 64 key tiles of 64. The bias terms arrive
// raw in natural column order, [N, S, W]; as in the TPU wrapper they are
// pre-scaled by 1/scale and rounded to bf16 before use (here when the
// block stages its [64, W] tables), then A[s][t / W] + Bb[s][t % W] is
// added to q.k before the scale. With `exp_bf16` the exponent argument
// and the probabilities are rounded to bf16, as in the TPU kernel's
// serving form.
#include "flash_core.cuh"

namespace ullava {

constexpr int kGlobHD = 80;
constexpr int kGlobW = 64;

struct GlobalAttn {
  const bf16* q;  // [N, S, 80]
  const bf16* k;
  const bf16* v;
  const bf16* a;   // [N, S, W]
  const bf16* bb;  // [N, S, W]
  bf16* o;
  int Sq, Sk;
  int q_offset;
  bool causal;
  float scale;
  float inv_scale;

  __device__ size_t row(int inst, int s) const { return static_cast<size_t>(inst) * Sq + s; }
  __device__ const bf16* q_row(int inst, int s) const { return q + row(inst, s) * kGlobHD; }
  __device__ const bf16* k_row(int inst, int t) const { return k + row(inst, t) * kGlobHD; }
  __device__ const bf16* v_row(int inst, int t) const { return v + row(inst, t) * kGlobHD; }
  __device__ bf16* o_row(int inst, int s) const { return o + row(inst, s) * kGlobHD; }
  __device__ int key_limit(int) const { return Sk; }
  __device__ float prescaled(const bf16* t, int inst, int s, int j) const {
    const float x = __bfloat162float(t[row(inst, s) * kGlobW + j]) * inv_scale;
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ float bias_a(int inst, int s, int j) const { return prescaled(a, inst, s, j); }
  __device__ float bias_b(int inst, int s, int j) const { return prescaled(bb, inst, s, j); }
};

}  // namespace ullava

// q, k, v, o: [N, 4096, 80] bf16; a, b: [N, 4096, 64] bf16.
ULLAVA_EXPORT int ullava_fused_global_attention(const void* q, const void* k,
                                                const void* v, const void* a,
                                                const void* b, void* o, int N,
                                                float scale, int exp_bf16, void* stream) {
  constexpr int S = ullava::kGlobW * ullava::kGlobW;
  ullava::GlobalAttn p{static_cast<const ullava::bf16*>(q),
                       static_cast<const ullava::bf16*>(k),
                       static_cast<const ullava::bf16*>(v),
                       static_cast<const ullava::bf16*>(a),
                       static_cast<const ullava::bf16*>(b),
                       static_cast<ullava::bf16*>(o),
                       S, S, 0, false, scale, 1.0f / scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (exp_bf16)
    return ullava::launch_flash<ullava::kGlobHD, ullava::kGlobW, ullava::GlobalAttn, true>(p, N,
                                                                                           st);
  return ullava::launch_flash<ullava::kGlobHD, ullava::kGlobW, ullava::GlobalAttn, false>(p, N, st);
}
