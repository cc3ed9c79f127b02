// fused_global_attention_y: SAM ViT global-block attention over the
// 64 x 64 grid (S = 4096, hd 80) that reads q, k and v in place from the
// raw [B, S, 3C] qkv projection output and writes the head-merged
// [B, S, C] activations, with the decomposed rel-pos bias and an online
// softmax.
//
// Replaces: ullava_tpu/ops/sam_attention.py:652 fused_global_attention_y
// (Pallas; a program handles a slab of heads whose lanes form 128-aligned
// blocks of y), in both of its forms: bf16 scores
// (`ullava_fused_global_attention_y`) and the int8 score form `dots_i8`
// (`ullava_fused_global_attention_y_i8`, kernel branch :596-617).
//
// Bound on the card: at ViT-H B=16 (256 (image, head) pairs) a layer does
// 256 * 4096 * 4096 * 80 * 4 = 1.37e12 flops of products, 1.39 ms at
// 989 TFLOP/s bf16, against ~1.2 GB of HBM traffic (0.35 ms): operations
// bound it.
//
// Design: the shared online-softmax core (flash_core.cuh), one block per
// (image, head, 64-row q tile). Head h of a section starts 160 bytes into
// it, which keeps every 16-byte cp.async aligned, so no head slab or lane
// alignment is needed and no q/k/v copy is staged. The bias terms arrive
// pre-scaled by 1/scale in natural column order, laid out [B, S, H, W] as
// the encoder's einsum leaves them; A[s][t / W] + Bb[s][t % W] is added to
// q.k before the scale. With `exp_bf16` the exponent argument and the
// probabilities are rounded to bf16 as in the TPU kernel's serving form.
//
// The dots_i8 form is the core's DOTS_I8 (flash_core.cuh): q, each K
// tile and the 128 bias terms [A | B] of a row quantized per row inside
// the block, qk on the int8 tensor cores (hd 80 padded to 96), P V in
// bf16. Bound at B=16: 0.35 ms of int8 qk plus 0.69 ms of bf16 P V, still
// operations.
#include "flash_core.cuh"

namespace ullava {

constexpr int kGlobYHD = 80;
constexpr int kGlobYW = 64;

struct GlobalAttnY {
  const bf16* y;   // [B, S, 3 * H * 80]
  const bf16* a;   // [B, S, H, W]
  const bf16* bb;  // [B, S, H, W]
  bf16* o;         // [B, S, H * 80]
  int Sq, Sk;
  int q_offset;
  bool causal;
  float scale;
  int H;

  __device__ size_t token(int inst, int s) const {
    return static_cast<size_t>(inst / H) * Sq + s;
  }
  __device__ const bf16* section(int inst, int s, int sec) const {
    return y + (token(inst, s) * 3 + sec) * (H * kGlobYHD) + (inst % H) * kGlobYHD;
  }
  __device__ const bf16* q_row(int inst, int s) const { return section(inst, s, 0); }
  __device__ const bf16* k_row(int inst, int t) const { return section(inst, t, 1); }
  __device__ const bf16* v_row(int inst, int t) const { return section(inst, t, 2); }
  __device__ bf16* o_row(int inst, int s) const {
    return o + token(inst, s) * (H * kGlobYHD) + (inst % H) * kGlobYHD;
  }
  __device__ int key_limit(int) const { return Sk; }
  __device__ float term(const bf16* t, int inst, int s, int j) const {
    return __bfloat162float(t[(token(inst, s) * H + inst % H) * kGlobYW + j]);
  }
  __device__ float bias_a(int inst, int s, int j) const { return term(a, inst, s, j); }
  __device__ float bias_b(int inst, int s, int j) const { return term(bb, inst, s, j); }
  static constexpr bool kPadKeys = false;
};

}  // namespace ullava

// y [B, 4096, 3 * H * 80], a, b [B, 4096, H, 64], o [B, 4096, H * 80], bf16.
ULLAVA_EXPORT int ullava_fused_global_attention_y(const void* y, const void* a, const void* b,
                                                  void* o, int B, int H, float scale,
                                                  int exp_bf16, void* stream) {
  constexpr int S = ullava::kGlobYW * ullava::kGlobYW;
  ullava::GlobalAttnY p{static_cast<const ullava::bf16*>(y),
                        static_cast<const ullava::bf16*>(a),
                        static_cast<const ullava::bf16*>(b),
                        static_cast<ullava::bf16*>(o),
                        S, S, 0, false, scale, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (exp_bf16)
    return ullava::launch_flash<ullava::kGlobYHD, ullava::kGlobYW, ullava::GlobalAttnY, true>(
        p, B * H, st);
  return ullava::launch_flash<ullava::kGlobYHD, ullava::kGlobYW, ullava::GlobalAttnY, false>(
      p, B * H, st);
}

// The dots_i8 form: int8 scores (q, k and the bias terms quantized per
// row), bf16 P V, either exponential form. Arguments as above.
ULLAVA_EXPORT int ullava_fused_global_attention_y_i8(const void* y, const void* a,
                                                     const void* b, void* o, int B, int H,
                                                     float scale, int exp_bf16, void* stream) {
  using namespace ullava;
  constexpr int S = kGlobYW * kGlobYW;
  GlobalAttnY p{static_cast<const bf16*>(y), static_cast<const bf16*>(a),
                static_cast<const bf16*>(b),  static_cast<bf16*>(o),
                S, S, 0, false, scale, H};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (exp_bf16)
    return launch_flash<kGlobYHD, kGlobYW, GlobalAttnY, true, true>(p, B * H, st);
  return launch_flash<kGlobYHD, kGlobYW, GlobalAttnY, false, true>(p, B * H, st);
}
