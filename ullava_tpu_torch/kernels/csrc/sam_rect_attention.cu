// fused_window_attention_rect: attention of the SAM encoder's boundary
// windows in the resident layout (hd 80, and hd 64 in bf16). A boundary
// window is stored as the T = rows x cols real tokens of a logical
// 14 x 14 window (right edge 14 x 8, bottom edge 8 x 14, corner 8 x 8 for
// ViT-H, ViT-L and ViT-B: a grid of 64); its other
// positions are the zero pad of the reference, which pads after LN1, so a
// pad token's key and value are exactly the k and v sections of the qkv
// bias, the same for every pad position of a head.
//
// Replaces: ullava_tpu/ops/sam_attention.py:354 fused_window_attention_rect
// (Pallas, kernel _rect_kernel :261; the P pad keys are appended after the
// T real ones as rows of a per-layer table [bias_k | one-hots], and the pad
// keys' probability mass times bias_v is added as a rank-1 term), in both
// of its forms: bf16 scores (`ullava_fused_window_attention_rect`) and the
// int8 score form `dots_i8` (`ullava_fused_window_attention_rect_i8`,
// kernel branch :313-332).
//
// Bound on the card: the merged right and bottom classes of a ViT-H layer
// at B=16 (N = 128 windows, T = 112, H = 16) read y (110 MB) and the two
// bias-term tensors (13 MB) and write 37 MB: ~160 MB, ~48 us of HBM time;
// the products over the real keys are 128*16*112*112*80*4 = 8.2 GFLOP,
// ~8 us of bf16 tensor-core time, so bytes bound it (both forms).
//
// Design: the whole-window core (window_whole.cuh) with pad keys, one
// block per (window, head) over the window's T query rows. Only the T real
// tokens are keys of the two products: their k and v rows (compact token
// j = a * cols + b, bias indices (j / cols, j % cols) at compile time: the
// geometry is a template parameter, instantiated for 14 x 8, 8 x 14 and
// 8 x 8) are copied into shared memory once. A pad position (a, b) gets
// the score (q . pad_k + A[a] + B[b]) * scale, q . pad_k one fp32 value a
// query row from the bf16 q and the table row pad_k[h][0][0:80] (the TPU's
// `qa . padk[h]`, :328-331); the pads enter the row max and sum, their
// probabilities are summed in fp32 unrounded, and pad_mass * pad_v is added
// to O in fp32 (:349-350). So no pad row is loaded and no pad key goes
// through an MMA: of the 196 logical keys the products skip 84 of an edge
// window and 132 of a corner one (43% and 67% of the tensor-core work of a
// kernel that multiplies them), and the score row of a thread holds 56 or
// 32 values instead of 104.
//
// The dots_i8 form: the real keys' scores are int8 (K quantized once per
// (window, head), q and the bias row [A | B] per row by each warp), the pad
// keys keep the TPU kernel's unquantized score against the constant table.
//
// The hd 64 form (`ullava_fused_window_attention_rect_hd64`, bf16 scores):
// ViT-L's and ViT-B's boundary windows, whose grid of 64 tokens leaves the
// same 14 x 8, 8 x 14 and 8 x 8 rectangles. The core runs it with HD = 64
// (128-byte swizzled K and V rows, 4 k-steps of Q K^T); the pad tables
// are [halves, H, P, 64 + 28]. Bound at one ViT-L B=1 block (the merged
// edges, N = 8, T = 112, H = 16): 6.9 MB in and out, ~2 us, against
// 0.2 GFLOP: bytes.
//
// Dual geometry: the right and bottom classes share one launch; windows
// [0, n_first) take (rows0, cols0) and half 0 of the stacked tables, the
// rest (rows1, cols1) and half 1. A single-geometry call has n_first = N.
#include "window_whole.cuh"

namespace ullava {

constexpr int kRectHD = 80;
constexpr int kRectWin = 14;

template <int HD>
struct WindowRect {
  const bf16* y;      // [N, T, 3C]
  const bf16* a;      // [N, T, H*W]
  const bf16* bb;     // [N, T, H*W]
  const bf16* pad_k;  // [halves, H, P, hd + 2W]; only [.., 0, 0:hd] is read
  const bf16* pad_v;  // [halves, H, hd]
  bf16* o;            // [N, T, C]
  int Sq, H;          // T real rows
  float scale;
  int n_first;        // windows of the first geometry
  int pad_k_head;     // elements between two heads' pad_k tables: P * (hd + 2W)
  static constexpr bool kBiasAfterScale = false;
  static constexpr bool kPadKeys = true;
  static constexpr bool kBiasRaw = false;

  __device__ int half(int inst) const { return inst / H >= n_first ? 1 : 0; }
  __device__ size_t row(int inst, int s) const {
    return static_cast<size_t>(inst / H) * Sq + s;
  }
  __device__ const bf16* q_row(int inst, int s) const {
    return y + row(inst, s) * (3 * H * HD) + (inst % H) * HD;
  }
  __device__ const bf16* k_row(int inst, int j) const { return q_row(inst, j) + H * HD; }
  __device__ const bf16* v_row(int inst, int j) const { return q_row(inst, j) + 2 * H * HD; }
  __device__ bf16* o_row(int inst, int s) const {
    return o + row(inst, s) * (H * HD) + (inst % H) * HD;
  }
  // The W terms of row s (term 0: A, 1: Bb), reversed columns.
  __device__ const bf16* bias_row(int inst, int s, int term) const {
    return (term ? bb : a) + row(inst, s) * (H * kRectWin) + (inst % H) * kRectWin;
  }
  __device__ const bf16* pad_k_row(int inst) const {
    return pad_k + static_cast<size_t>(half(inst) * H + inst % H) * pad_k_head;
  }
  __device__ const bf16* pad_v_row(int inst) const {
    return pad_v + (half(inst) * H + inst % H) * HD;
  }
};

using RectRight = WwRect<14, 8>;
using RectBottom = WwRect<8, 14>;
using RectCorner = WwRect<8, 8>;

// Calls f with the geometry pair (G0, G1) of (rows0, cols0), (rows1,
// cols1): the ViT-H classes alone or the two edges in either order;
// anything else is refused.
template <class F>
int with_geometry(int rows0, int cols0, int rows1, int cols1, F f) {
  const int k0 = rows0 * 16 + cols0, k1 = rows1 * 16 + cols1;
  constexpr int kR = 14 * 16 + 8, kB = 8 * 16 + 14, kC = 8 * 16 + 8;
  if (k0 == kR && k1 == kR) return f(RectRight{}, RectRight{});
  if (k0 == kB && k1 == kB) return f(RectBottom{}, RectBottom{});
  if (k0 == kC && k1 == kC) return f(RectCorner{}, RectCorner{});
  if (k0 == kR && k1 == kB) return f(RectRight{}, RectBottom{});
  if (k0 == kB && k1 == kR) return f(RectBottom{}, RectRight{});
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int HD, bool I8>
int launch_rect(const void* y, const void* a, const void* b, const void* pad_k,
                const void* pad_v, void* o, int N, int H, int T, int P, int n_first, int rows0,
                int cols0, int rows1, int cols1, float scale, void* stream) {
  const WindowRect<HD> p{static_cast<const bf16*>(y),     static_cast<const bf16*>(a),
                         static_cast<const bf16*>(b),     static_cast<const bf16*>(pad_k),
                         static_cast<const bf16*>(pad_v), static_cast<bf16*>(o),
                         T, H, scale, n_first, P * (HD + 2 * kRectWin)};
  return with_geometry(rows0, cols0, rows1, cols1, [&](auto g0, auto g1) {
    return launch_window_whole<HD, kRectWin, WindowRect<HD>, decltype(g0), decltype(g1), I8>(
        p, N * H, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace ullava

// y: [N, T, 3*H*80] bf16; a, b: [N, T, H*14] bf16; pad_k: [halves, H, P, 108]
// bf16; pad_v: [halves, H, 80] bf16; o: [N, T, H*80] bf16. T = rows * cols
// for both geometries, T + P = 196.
ULLAVA_EXPORT int ullava_fused_window_attention_rect(const void* y, const void* a, const void* b,
                                                     const void* pad_k, const void* pad_v,
                                                     void* o, int N, int H, int T, int P,
                                                     int n_first, int rows0, int cols0,
                                                     int rows1, int cols1, float scale,
                                                     void* stream) {
  return ullava::launch_rect<ullava::kRectHD, false>(y, a, b, pad_k, pad_v, o, N, H, T, P,
                                                     n_first, rows0, cols0, rows1, cols1,
                                                     scale, stream);
}

// The dots_i8 form: int8 scores over the real keys, the pad keys' scores
// unquantized, bf16 P V. Arguments as above.
ULLAVA_EXPORT int ullava_fused_window_attention_rect_i8(const void* y, const void* a,
                                                        const void* b, const void* pad_k,
                                                        const void* pad_v, void* o, int N, int H,
                                                        int T, int P, int n_first, int rows0,
                                                        int cols0, int rows1, int cols1,
                                                        float scale, void* stream) {
  return ullava::launch_rect<ullava::kRectHD, true>(y, a, b, pad_k, pad_v, o, N, H, T, P,
                                                    n_first, rows0, cols0, rows1, cols1,
                                                    scale, stream);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the kernel of one form (i8) and geometry pair.
ULLAVA_EXPORT int ullava_window_attention_rect_attrs(int i8, int rows0, int cols0, int rows1,
                                                     int cols1, int* out) {
  using namespace ullava;
  return with_geometry(rows0, cols0, rows1, cols1, [&](auto g0, auto g1) {
    using G0 = decltype(g0);
    using G1 = decltype(g1);
    return i8 ? window_whole_attrs<kRectHD, kRectWin, WindowRect<kRectHD>, G0, G1, true>(out)
              : window_whole_attrs<kRectHD, kRectWin, WindowRect<kRectHD>, G0, G1, false>(out);
  });
}

// The hd 64 form (ViT-L and ViT-B), bf16 scores. y: [N, T, 3*H*64] bf16;
// a, b: [N, T, H*14] bf16; pad_k: [halves, H, P, 92] bf16; pad_v:
// [halves, H, 64] bf16; o: [N, T, H*64] bf16. T = rows * cols for both
// geometries, T + P = 196.
ULLAVA_EXPORT int ullava_fused_window_attention_rect_hd64(const void* y, const void* a,
                                                          const void* b, const void* pad_k,
                                                          const void* pad_v, void* o, int N,
                                                          int H, int T, int P, int n_first,
                                                          int rows0, int cols0, int rows1,
                                                          int cols1, float scale, void* stream) {
  return ullava::launch_rect<64, false>(y, a, b, pad_k, pad_v, o, N, H, T, P, n_first, rows0,
                                        cols0, rows1, cols1, scale, stream);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the hd 64 form's kernel at one geometry pair.
ULLAVA_EXPORT int ullava_window_attention_rect_hd64_attrs(int rows0, int cols0, int rows1,
                                                          int cols1, int* out) {
  using namespace ullava;
  return with_geometry(rows0, cols0, rows1, cols1, [&](auto g0, auto g1) {
    return window_whole_attrs<64, kRectWin, WindowRect<64>, decltype(g0), decltype(g1), false>(
        out);
  });
}
