// fused_global_attention: SAM ViT global-block attention over the 64 x 64
// grid (S = 4096, hd 80 for ViT-H, hd 64 for ViT-L and ViT-B) with the
// decomposed rel-pos bias, online softmax.
//
// Replaces: ullava_tpu/ops/sam_attention.py:490 fused_global_attention
// (Pallas, transpose-staged [B*H, S, hd] layout, tiled flash).
//
// Bound on the card: at ViT-H B=4 (N = 64 instances) a global layer does
// 64*4096*4096*80*4 = 344 GFLOP of products, ~0.35 ms at 989 TFLOP/s
// bf16, against ~0.2 GB of HBM traffic (~0.06 ms): operations bound it.
//
// Design: the wgmma + TMA global core (global_sm90.cuh, which K11 and K20
// run on) with a problem type of its own, launched with B = N and H = 1:
// q, k and v are three [N, S, 80] tensors, read by TMA through three views
// (no copy stacks them), and the bias terms arrive raw in natural column
// order, [N, S, 64]; as in the TPU wrapper the core pre-scales them by
// 1/scale and rounds them to bf16 where it reads them (the B terms once a
// query tile, the A term twice a row a key tile), then adds A[s][t / 64] +
// B[s][t % 64] to q.k before the scale. With `exp_bf16` the exponent
// argument and the probabilities are rounded to bf16, as in the TPU
// kernel's serving form. The core's output [B, S, H * HD] is K4's
// [N, S, HD].
//
// The hd 64 form (`ullava_fused_global_attention_hd64`): the same core at
// HD = 64, one 64-column TMA box a row and 4 k-steps of wgmma.m64n128k16.
// Its bound at one ViT-L B=1 global block (N = 16): 16*4096*4096*64*4 =
// 68.7 GFLOP, ~69 us at the bf16 peak, against ~42 MB (~13 us): operations.
//
// Compiled with ULLAVA_MUTANT_GLOBAL_BIAS_RAW (global_sm90.cuh) the kernel
// reads the bias terms without the 1/scale pre-scale: a deliberate bug
// that only `chip_smoke.py` builds, to show that the gate catches it; so
// does the core's ULLAVA_MUTANT_GLOBAL_A_ONE_ROW.
#include "global_sm90.cuh"

namespace ullava {

constexpr int kGlobHD = 80;

// K4's layout for the global core (B = N instances, H = 1): q, k, v each
// [N, S, HD] as the view {d, 1, s, n}, the raw bias terms [N, S, 64] as
// K11's view {j, h, s, n} with H = 1, added before the scale.
template <int HD>
struct HeadMajorGlobal : glob::BiasBSHW {
  static constexpr int kHD = HD;
  static constexpr bool kBiasAfterScale = false;
  static constexpr bool kBiasRaw = true;
  static constexpr int kQkvHeads = 1;
  __device__ static int k_head(int h, int) { return h; }
  __device__ static int v_head(int h, int) { return h; }
};

template <int HD, bool EXPBF16>
int launch_global_head_major(const void* q, const void* k, const void* v, const void* a,
                             const void* b, void* o, int N, float scale, cudaStream_t st) {
  const glob::Params p{static_cast<bf16*>(o), nullptr, nullptr, N, 1,
                       EXPBF16 ? scale : scale * glob::kLog2e, 1.0f / scale};
  return glob::launch_global<HeadMajorGlobal<HD>, EXPBF16, false>(q, k, v, a, b, nullptr,
                                                                  nullptr, p, st);
}

}  // namespace ullava

// q, k, v, o: [N, 4096, 80] bf16; a, b: [N, 4096, 64] bf16 raw (pre-scaled
// by 1/scale and rounded to bf16 in the kernel).
ULLAVA_EXPORT int ullava_fused_global_attention(const void* q, const void* k,
                                                const void* v, const void* a,
                                                const void* b, void* o, int N,
                                                float scale, int exp_bf16, void* stream) {
  using namespace ullava;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exp_bf16 ? launch_global_head_major<kGlobHD, true>(q, k, v, a, b, o, N, scale, st)
                  : launch_global_head_major<kGlobHD, false>(q, k, v, a, b, o, N, scale, st);
}

// The hd 64 form (ViT-L and ViT-B): q, k, v, o [N, 4096, 64] bf16; a, b
// as above.
ULLAVA_EXPORT int ullava_fused_global_attention_hd64(const void* q, const void* k,
                                                     const void* v, const void* a,
                                                     const void* b, void* o, int N,
                                                     float scale, int exp_bf16, void* stream) {
  using namespace ullava;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exp_bf16 ? launch_global_head_major<64, true>(q, k, v, a, b, o, N, scale, st)
                  : launch_global_head_major<64, false>(q, k, v, a, b, o, N, scale, st);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the global form's kernel (`exp_bf16` 0 or 1).
ULLAVA_EXPORT int ullava_fused_global_attention_attrs(int exp_bf16, int* out) {
  using namespace ullava;
  return exp_bf16 ? glob::attrs<HeadMajorGlobal<kGlobHD>, true, false>(out)
                  : glob::attrs<HeadMajorGlobal<kGlobHD>, false, false>(out);
}

// The same of the hd 64 form's kernel.
ULLAVA_EXPORT int ullava_fused_global_attention_hd64_attrs(int exp_bf16, int* out) {
  using namespace ullava;
  return exp_bf16 ? glob::attrs<HeadMajorGlobal<64>, true, false>(out)
                  : glob::attrs<HeadMajorGlobal<64>, false, false>(out);
}
