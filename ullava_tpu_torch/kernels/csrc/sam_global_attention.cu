// fused_global_attention: SAM ViT global-block attention over the 64 x 64
// grid (S = 4096, hd 80) with the decomposed rel-pos bias, online softmax;
// and fused_window_attention, the same function per (window, head) over a
// 14 x 14 window (S = 196, hd 80).
//
// Replaces: ullava_tpu/ops/sam_attention.py:490 fused_global_attention
// (Pallas, transpose-staged [B*H, S, hd] layout, tiled flash), and :70
// fused_window_attention (Pallas, kernel _kernel :29: n_block (window,
// head) pairs a program, the bias folded into the qk dot as one-hot
// augmented q/k, exact softmax normalized before the bf16 P V).
//
// Bound on the card: at ViT-H B=4 (N = 64 instances) a global layer does
// 64*4096*4096*80*4 = 344 GFLOP of products, ~0.35 ms at 989 TFLOP/s
// bf16, against ~0.2 GB of HBM traffic (~0.06 ms): operations bound it.
// A window layer in the head-major layout (N = 1600 (window, head) pairs,
// S = 196) reads q, k, v (150 MB) and the bias terms (17.6 MB) and writes
// 50 MB: ~65 us of HBM time against 19.7 GFLOP (~20 us): bytes bound it.
//
// Design: the shared online-softmax core (flash_core.cuh), one block per
// (instance, 64-row q tile), key tiles of 64 (196 keys: four, the last
// masked past 196). The bias terms arrive raw in natural column order,
// [N, S, W]; as in the TPU wrappers they are pre-scaled by 1/scale and
// rounded to bf16 before use (here when the block stages its [64, W]
// tables), then A[s][t / W] + Bb[s][t % W] is added to q.k before the
// scale. With `exp_bf16` the exponent argument and the probabilities are
// rounded to bf16, as in the TPU kernel's serving form. The window form
// normalizes P before rounding it to bf16, as its TPU kernel does (:63-65),
// and so runs on window_norm_first.cuh over the same accessor. The
// accessor is one template over W; the global form's machine code is that
// of the accessor before the template.
//
// Compiled with ULLAVA_MUTANT_WINDOW_BIAS_RAW the window form reads the
// bias terms without the 1/scale pre-scale: a deliberate bug that only
// `chip_smoke.py` builds, to show that the window form's gate catches it.
#include "window_norm_first.cuh"

namespace ullava {

constexpr int kGlobHD = 80;
constexpr int kGlobW = 64;
constexpr int kWinW = 14;

template <int W>
struct DecomposedAttn {
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
#ifdef ULLAVA_MUTANT_WINDOW_BIAS_RAW
    if (W == kWinW) return __bfloat162float(t[row(inst, s) * W + j]);
#endif
    const float x = __bfloat162float(t[row(inst, s) * W + j]) * inv_scale;
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ float bias_a(int inst, int s, int j) const { return prescaled(a, inst, s, j); }
  __device__ float bias_b(int inst, int s, int j) const { return prescaled(bb, inst, s, j); }
};

using GlobalAttn = DecomposedAttn<kGlobW>;

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

// q, k, v, o: [N, 196, 80] bf16 (N = windows x heads); a, b: [N, 196, 14]
// bf16 raw (pre-scaled by 1/scale and rounded to bf16 in the kernel).
ULLAVA_EXPORT int ullava_fused_window_attention(const void* q, const void* k, const void* v,
                                                const void* a, const void* b, void* o, int N,
                                                float scale, void* stream) {
  using namespace ullava;
  constexpr int S = kWinW * kWinW;
  DecomposedAttn<kWinW> p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<const bf16*>(a),
                          static_cast<const bf16*>(b), static_cast<bf16*>(o),
                          S, S, 0, false, scale, 1.0f / scale};
  return launch_flash_norm_first<kGlobHD, kWinW>(p, N, static_cast<cudaStream_t>(stream));
}
