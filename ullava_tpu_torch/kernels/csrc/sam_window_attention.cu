// fused_window_attention_grid: SAM ViT window attention (14 x 14 windows,
// hd 80, and hd 64) read straight from the raw qkv projection output, with the
// decomposed rel-pos bias, writing the head-merged output; and
// fused_window_attention, the same function per (window, head) pair in
// the head-major layout.
//
// Replaces: ullava_tpu/ops/sam_attention.py:181 fused_window_attention_grid
// (Pallas, kernel _grid_kernel :113; bias folded into the qk dot as
// one-hot-augmented q/k), in both of its forms: bf16 scores
// (`ullava_fused_window_attention_grid`) and the int8 score form `dots_i8`
// (`ullava_fused_window_attention_grid_i8`, kernel branch :146-161); and
// :70 fused_window_attention (`ullava_fused_window_attention`, kernel
// _kernel :29: n_block (window, head) pairs a program, the same one-hot
// fold, an exact softmax normalized before the bf16 P V).
//
// Bound on the card: at ViT-H B=4 (N = 100 windows, S = 196, H = 16) a
// layer reads y (150 MB) and the two bias-term tensors (18 MB) and
// writes 50 MB: ~218 MB, ~65 us of HBM time; the products are
// 100*16*196*196*80*4 = 19.7 GFLOP, ~20 us of bf16 tensor-core time, so
// bytes bound it. The dots_i8 form at one ViT-H B=16 block in the padded
// layout (N = 256, S = 200): bytes again, ~570 MB (~170 us of HBM time)
// against ~13 us of int8 qk and ~26 us of bf16 P V.
//
// Design: the whole-window core (window_whole.cuh), one block per (window,
// head) over every query row of the window: K and V (the window's 196 key
// rows, hd 80 in 176-byte rows) copied into shared memory once, each
// warp's score row whole in registers, P normalized before it is rounded
// to bf16, as the TPU kernel rounds it (:173-175). q/k/v of head h are
// 80-element slices of a y row at offsets h*80, C + h*80, 2C + h*80; the
// output lands at h*80 of the merged [N, S, C] row, so no head split/merge
// copy exists. The bias terms arrive as on the TPU: [N, S, H*W],
// pre-scaled by 1/scale, columns reversed (column a' is key row W-1-a');
// a warp prefetches its next tile's 14 + 14 terms a row with its q rows,
// and s = (q.k + A[s][t / W] + Bb[s][t % W]) * scale.
//
// The padded layout of the resident encoder stores a window as
// `total_rows` >= 196 rows (200 for ViT-H, so that the token axis is a
// multiple of 8; the core holds up to 208): Sq and the row stride are
// total_rows while the keys stay the first 196 rows, so the tail rows are
// never loaded as keys. As queries they are computed and written like any
// row (finite, dropped by the caller), so no later kernel reads memory
// that was never written.
//
// The head-major form (WindowHeadMajor): q, k and v are three [N, 196, 80]
// tensors, so an instance's rows are contiguous 160-byte rows, and the
// bias terms arrive raw, [N, 196, 14], in natural column order (A indexed
// by t / 14, B by t % 14). The core scales each term by 1/scale and rounds
// it to bf16 where it reads it, the TPU wrapper's `(bias * inv).astype(
// q.dtype)` (:88-90), so the arithmetic is K3's point for point. Its
// bound: at one ViT-H B=4 window block (N = 1600 pairs) it reads q, k, v
// (150 MB) and the terms (17.6 MB) and writes 50 MB, ~65 us of HBM time
// against 19.7 GFLOP (~20 us): bytes.
//
// The hd 64 form (`ullava_fused_window_attention_grid_hd64`, bf16 scores):
// ViT-L's and ViT-B's window blocks (1024 / 16 and 768 / 12 lanes a head),
// which reach the same TPU kernel with head_dim 64. The core runs it with
// HD = 64: a K or V row is 8 sixteen-byte chunks, so rows are 128 bytes
// with the chunks XOR-swizzled by the row's low three bits (window_whole.cuh),
// Q K^T takes 4 k-steps of mma.sync.m16n8k16 instead of 5 and a thread
// holds 16 Q and 32 O registers, 4 warps a (window, head) as at hd 80
// (window_whole.cuh's header says why not a warp a query tile), with the
// hd 64 forms' exponential and quotient. Its bound at one ViT-L B=1 window
// block (N = 16 full windows, H = 16): y 19.3 MB, the terms 2.8 MB, o
// 6.4 MB, ~8.5 us of HBM time, against 2.5 GFLOP (~2.5 us): bytes.
//
// The dots_i8 form: K quantized per row to int8 once per (window, head),
// q and the bias-term row [A | B] per row by each warp, qk on the int8
// tensor cores (hd 80 zero-padded to 96: three m16n8k32 steps), the
// one-hot expansion of the TPU kernel as the sum of two codes, P V in bf16.
//
// Its hd 64 form (`ullava_fused_window_attention_grid_i8_hd64`): ViT-L's
// and ViT-B's window blocks with `attn_dots_i8`, 196 rows a window or the
// resident layout's 200. Q K^T is two m16n8k32 steps; K's codes stay in
// the swizzled 128-byte rows of its bf16 copy (window_whole.cuh). Bound at
// one ViT-L B=1 block in the padded layout (N = 16, S = 200, H = 16):
// y 19.7 MB, the terms 2.9 MB, o 6.6 MB, ~8.7 us of HBM time against
// ~0.6 us of int8 qk and ~1.3 us of bf16 P V: bytes.
//
// Compiled with ULLAVA_MUTANT_WINDOW_BIAS_RAW the head-major form reads its
// bias terms without the 1/scale pre-scale: a deliberate bug that only
// `chip_smoke.py` builds, to show that the gate catches it.
#include "window_whole.cuh"

namespace ullava {

constexpr int kWinHD = 80;
constexpr int kWin = 14;
using WholeWindow = WwRect<kWin, kWin>;

template <int HD>
struct WindowGrid {
  const bf16* y;   // [N, S, 3C]
  const bf16* a;   // [N, S, H*W]
  const bf16* bb;  // [N, S, H*W]
  bf16* o;         // [N, S, C]
  int Sq, H;
  float scale;
  static constexpr bool kBiasAfterScale = false;
  static constexpr bool kPadKeys = false;
  static constexpr bool kBiasRaw = false;

  __device__ size_t row(int inst, int s) const {
    return static_cast<size_t>(inst / H) * Sq + s;
  }
  __device__ const bf16* q_row(int inst, int s) const {
    return y + row(inst, s) * (3 * H * HD) + (inst % H) * HD;
  }
  __device__ const bf16* k_row(int inst, int t) const {
    return q_row(inst, t) + H * HD;
  }
  __device__ const bf16* v_row(int inst, int t) const {
    return q_row(inst, t) + 2 * H * HD;
  }
  __device__ bf16* o_row(int inst, int s) const {
    return o + row(inst, s) * (H * HD) + (inst % H) * HD;
  }
  // The W terms of row s (term 0: A, 1: Bb), reversed columns.
  __device__ const bf16* bias_row(int inst, int s, int term) const {
    return (term ? bb : a) + row(inst, s) * (H * kWin) + (inst % H) * kWin;
  }
};

// K21: q, k, v, o [N, 196, 80]; the raw bias terms [N, 196, 14].
struct WindowHeadMajor {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* a;
  const bf16* bb;
  bf16* o;
  int Sq;
  float scale;
  float inv_scale;
  static constexpr bool kBiasAfterScale = false;
  static constexpr bool kPadKeys = false;
  static constexpr bool kBiasRaw = true;

  __device__ size_t row(int inst, int s) const { return static_cast<size_t>(inst) * Sq + s; }
  __device__ const bf16* q_row(int inst, int s) const { return q + row(inst, s) * kWinHD; }
  __device__ const bf16* k_row(int inst, int t) const { return k + row(inst, t) * kWinHD; }
  __device__ const bf16* v_row(int inst, int t) const { return v + row(inst, t) * kWinHD; }
  __device__ bf16* o_row(int inst, int s) const { return o + row(inst, s) * kWinHD; }
  // The W terms of row s (term 0: A, 1: Bb), natural columns, raw.
  __device__ const bf16* bias_row(int inst, int s, int term) const {
    return (term ? bb : a) + row(inst, s) * kWin;
  }
  // A raw term as the TPU wrapper pre-scales it: times 1/scale, to bf16.
  __device__ float prescaled(float x) const {
#ifdef ULLAVA_MUTANT_WINDOW_BIAS_RAW
    return x;
#else
    return __bfloat162float(__float2bfloat16_rn(x * inv_scale));
#endif
  }
};

template <int HD, bool I8>
int launch_grid(const void* y, const void* a, const void* b, void* o, int N, int H,
                int total_rows, float scale, void* stream) {
  WindowGrid<HD> p{static_cast<const bf16*>(y), static_cast<const bf16*>(a),
                   static_cast<const bf16*>(b), static_cast<bf16*>(o), total_rows, H, scale};
  return launch_window_whole<HD, kWin, WindowGrid<HD>, WholeWindow, WholeWindow, I8>(
      p, N * H, static_cast<cudaStream_t>(stream));
}

}  // namespace ullava

// y: [N, S, 3*H*80] bf16; a, b: [N, S, H*14] bf16; o: [N, S, H*80] bf16,
// S = total_rows in [196, 208].
ULLAVA_EXPORT int ullava_fused_window_attention_grid(const void* y, const void* a,
                                                     const void* b, void* o, int N,
                                                     int H, int total_rows, float scale,
                                                     void* stream) {
  return ullava::launch_grid<ullava::kWinHD, false>(y, a, b, o, N, H, total_rows, scale,
                                                     stream);
}

// The dots_i8 form: int8 scores (q, k and the bias terms quantized per
// row), bf16 P V. Arguments as above.
ULLAVA_EXPORT int ullava_fused_window_attention_grid_i8(const void* y, const void* a,
                                                        const void* b, void* o, int N, int H,
                                                        int total_rows, float scale,
                                                        void* stream) {
  return ullava::launch_grid<ullava::kWinHD, true>(y, a, b, o, N, H, total_rows, scale,
                                                    stream);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the bf16 (i8 = 0) or int8 score form's kernel.
ULLAVA_EXPORT int ullava_window_attention_grid_attrs(int i8, int* out) {
  using namespace ullava;
  return i8 ? window_whole_attrs<kWinHD, kWin, WindowGrid<kWinHD>, WholeWindow, WholeWindow, true>(
                 out)
            : window_whole_attrs<kWinHD, kWin, WindowGrid<kWinHD>, WholeWindow, WholeWindow, false>(
                 out);
}

// The hd 64 form (ViT-L and ViT-B: 1024 / 16 and 768 / 12), bf16 scores.
// y: [N, S, 3*H*64] bf16; a, b: [N, S, H*14] bf16; o: [N, S, H*64] bf16,
// S = total_rows in [196, 208].
ULLAVA_EXPORT int ullava_fused_window_attention_grid_hd64(const void* y, const void* a,
                                                          const void* b, void* o, int N, int H,
                                                          int total_rows, float scale,
                                                          void* stream) {
  return ullava::launch_grid<64, false>(y, a, b, o, N, H, total_rows, scale, stream);
}

// The hd 64 form's int8 scores (`dots_i8`). Arguments as above.
ULLAVA_EXPORT int ullava_fused_window_attention_grid_i8_hd64(const void* y, const void* a,
                                                             const void* b, void* o, int N,
                                                             int H, int total_rows, float scale,
                                                             void* stream) {
  return ullava::launch_grid<64, true>(y, a, b, o, N, H, total_rows, scale, stream);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the hd 64 form's kernel, bf16 (i8 = 0) or int8 scores.
ULLAVA_EXPORT int ullava_window_attention_grid_hd64_attrs(int i8, int* out) {
  using namespace ullava;
  return i8 ? window_whole_attrs<64, kWin, WindowGrid<64>, WholeWindow, WholeWindow, true>(out)
            : window_whole_attrs<64, kWin, WindowGrid<64>, WholeWindow, WholeWindow, false>(out);
}

// q, k, v, o: [N, 196, 80] bf16 (N = windows x heads); a, b: [N, 196, 14]
// bf16 raw, natural column order (pre-scaled by 1/scale and rounded to
// bf16 in the kernel).
ULLAVA_EXPORT int ullava_fused_window_attention(const void* q, const void* k, const void* v,
                                                const void* a, const void* b, void* o, int N,
                                                float scale, void* stream) {
  using namespace ullava;
  const WindowHeadMajor p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<const bf16*>(a),
                          static_cast<const bf16*>(b), static_cast<bf16*>(o),
                          kWin * kWin, scale, 1.0f / scale};
  return launch_window_whole<kWinHD, kWin, WindowHeadMajor>(p, N,
                                                            static_cast<cudaStream_t>(stream));
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the head-major form's kernel (`form` unused).
ULLAVA_EXPORT int ullava_fused_window_attention_attrs(int, int* out) {
  using namespace ullava;
  return window_whole_attrs<kWinHD, kWin, WindowHeadMajor>(out);
}
