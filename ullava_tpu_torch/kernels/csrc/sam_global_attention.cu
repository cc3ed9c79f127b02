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
// Design of the global form: the wgmma + TMA global core (global_sm90.cuh,
// which K11 and K20 run on) with a problem type of its own, launched with
// B = N and H = 1: q, k and v are three [N, S, 80] tensors, read by TMA
// through three views (no copy stacks them), and the bias terms arrive
// raw in natural column order, [N, S, 64]; as in the TPU wrapper the core
// pre-scales them by 1/scale and rounds them to bf16 where it reads them
// (the B terms once a query tile, the A term twice a row a key tile), then
// adds A[s][t / 64] + B[s][t % 64] to q.k before the scale. With
// `exp_bf16` the exponent argument and the probabilities are rounded to
// bf16, as in the TPU kernel's serving form. The core's output [B, S, H *
// 80] is K4's [N, S, 80].
//
// The window form normalizes P before rounding it to bf16, as its TPU
// kernel does (:63-65), and so runs on window_norm_first.cuh (the
// mma.sync blocks of flash_core.cuh), its tables of the bias terms
// pre-scaled as they are staged.
//
// Compiled with ULLAVA_MUTANT_WINDOW_BIAS_RAW the window form reads the
// bias terms without the 1/scale pre-scale, and with
// ULLAVA_MUTANT_GLOBAL_BIAS_RAW (global_sm90.cuh) the global form does:
// deliberate bugs that only `chip_smoke.py` builds, to show that the gates
// catch them; so does the core's ULLAVA_MUTANT_GLOBAL_A_ONE_ROW.
#include "global_sm90.cuh"
#include "window_norm_first.cuh"

namespace ullava {

constexpr int kGlobHD = 80;
constexpr int kWinW = 14;

// K4's layout for the global core (B = N instances, H = 1): q, k, v each
// [N, S, 80] as the view {d, 1, s, n}, the raw bias terms [N, S, 64] as
// K11's view {j, h, s, n} with H = 1, added before the scale.
struct HeadMajorGlobal : glob::BiasBSHW {
  static constexpr int kHD = kGlobHD;
  static constexpr bool kBiasAfterScale = false;
  static constexpr bool kBiasRaw = true;
  static constexpr int kQkvHeads = 1;
  __device__ static int k_head(int h, int) { return h; }
  __device__ static int v_head(int h, int) { return h; }
};

// The window form's accessor: q, k, v, o [N, 196, 80], raw bias terms
// [N, 196, 14], pre-scaled as the block stages them.
struct WindowAttn {
  const bf16* q;  // [N, S, 80]
  const bf16* k;
  const bf16* v;
  const bf16* a;   // [N, S, W]
  const bf16* bb;  // [N, S, W]
  bf16* o;
  int Sq, Sk;
  float scale;
  float inv_scale;

  __device__ size_t row(int inst, int s) const { return static_cast<size_t>(inst) * Sq + s; }
  __device__ const bf16* q_row(int inst, int s) const { return q + row(inst, s) * kGlobHD; }
  __device__ const bf16* k_row(int inst, int t) const { return k + row(inst, t) * kGlobHD; }
  __device__ const bf16* v_row(int inst, int t) const { return v + row(inst, t) * kGlobHD; }
  __device__ bf16* o_row(int inst, int s) const { return o + row(inst, s) * kGlobHD; }
  __device__ int key_limit(int) const { return Sk; }
  __device__ float prescaled(const bf16* t, int inst, int s, int j) const {
    const float x = __bfloat162float(t[row(inst, s) * kWinW + j]);
#ifdef ULLAVA_MUTANT_WINDOW_BIAS_RAW
    return x;
#else
    return __bfloat162float(__float2bfloat16(x * inv_scale));
#endif
  }
  __device__ float bias_a(int inst, int s, int j) const { return prescaled(a, inst, s, j); }
  __device__ float bias_b(int inst, int s, int j) const { return prescaled(bb, inst, s, j); }
};

template <bool EXPBF16>
int launch_global_head_major(const void* q, const void* k, const void* v, const void* a,
                             const void* b, void* o, int N, float scale, cudaStream_t st) {
  const glob::Params p{static_cast<bf16*>(o), nullptr, nullptr, N, 1,
                       EXPBF16 ? scale : scale * glob::kLog2e, 1.0f / scale};
  return glob::launch_global<HeadMajorGlobal, EXPBF16, false>(q, k, v, a, b, nullptr, nullptr,
                                                              p, st);
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
  return exp_bf16 ? launch_global_head_major<true>(q, k, v, a, b, o, N, scale, st)
                  : launch_global_head_major<false>(q, k, v, a, b, o, N, scale, st);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the global form's kernel (`exp_bf16` 0 or 1).
ULLAVA_EXPORT int ullava_fused_global_attention_attrs(int exp_bf16, int* out) {
  using namespace ullava;
  return exp_bf16 ? glob::attrs<HeadMajorGlobal, true, false>(out)
                  : glob::attrs<HeadMajorGlobal, false, false>(out);
}

// q, k, v, o: [N, 196, 80] bf16 (N = windows x heads); a, b: [N, 196, 14]
// bf16 raw (pre-scaled by 1/scale and rounded to bf16 in the kernel).
ULLAVA_EXPORT int ullava_fused_window_attention(const void* q, const void* k, const void* v,
                                                const void* a, const void* b, void* o, int N,
                                                float scale, void* stream) {
  using namespace ullava;
  constexpr int S = kWinW * kWinW;
  WindowAttn p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const bf16*>(a),
               static_cast<const bf16*>(b), static_cast<bf16*>(o),
               S, S, scale, 1.0f / scale};
  return launch_flash_norm_first<kGlobHD, kWinW>(p, N, static_cast<cudaStream_t>(stream));
}
