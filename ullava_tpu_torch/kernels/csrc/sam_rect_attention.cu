// fused_window_attention_rect: attention of the SAM encoder's boundary
// windows in the resident layout. A boundary window is stored as the
// T = rows x cols real tokens of a logical 14 x 14 window (right edge
// 14 x 8, bottom edge 8 x 14, corner 8 x 8 for ViT-H); its other
// positions are the zero pad of the reference, which pads after LN1, so a
// pad token's key and value are exactly the k and v sections of the qkv
// bias, the same for every pad position of a head.
//
// Replaces: ullava_tpu/ops/sam_attention.py:354 fused_window_attention_rect
// (Pallas; the P pad keys are appended after the T real ones as rows of a
// per-layer table [bias_k | one-hots], and the pad keys' probability mass
// times bias_v is added as a rank-1 term), in both of its forms: bf16
// scores (`ullava_fused_window_attention_rect`) and the int8 score form
// `dots_i8` (`ullava_fused_window_attention_rect_i8`, kernel branch
// :313-332).
//
// Bound on the card: the merged right and bottom classes of a ViT-H layer
// at B=16 (N = 128 windows, T = 112, H = 16) read y (110 MB) and the two
// bias-term tensors (13 MB) and write 37 MB: ~160 MB, ~48 us of HBM time;
// the products are 128*16*112*196*80*4 = 14.4 GFLOP, ~15 us of bf16
// tensor-core time, so bytes bound it.
//
// Design: the same function, not the same blocks. On this card it is an
// ordinary window attention over the 196 logical key positions on the
// shared online-softmax core (flash_core.cuh), one block per (window,
// head, 64-row q tile): key t = (a, b) = (t / 14, t % 14) is a row of y
// when (a, b) lies inside the real rectangle (token a * cols + b), and
// else the head's constant row, read in place from the pad tables
// (pad_k[h][0][0:80], pad_v[h]). So the bias lookup of the window kernel,
// A[s][t / 14] + Bb[s][t % 14] with the unscaled q behind both terms,
// holds unchanged for real and pad keys alike, the pad tables' one-hot
// columns are not read, and nothing is appended or summed apart. One
// difference in rounding follows: the TPU kernel sums the pad keys'
// probabilities in fp32 unrounded, here they are rounded to bf16 like
// every other key's before the value product.
//
// The dots_i8 form is the core's DOTS_I8 (flash_core.cuh) with pad keys:
// the real keys' scores are int8 (q, k and the bias row [A | B] quantized
// per row inside the block), the pad keys keep the TPU kernel's score
// against the constant table, from the unquantized q and bias terms:
// q . pad_k (one value a query row, computed when Q is staged) + A + B.
// The pad keys' value is still read as a row, so the pad mass times pad_v
// is the rank-1 term of the TPU kernel, summed with the real keys.
// Bound as the bf16 form: bytes.
//
// Dual geometry: the right and bottom classes share one launch; windows
// [0, n_first) take (rows0, cols0) and half 0 of the stacked tables, the
// rest (rows1, cols1) and half 1. A single-geometry call has n_first = N.
#include "flash_core.cuh"

namespace ullava {

constexpr int kRectHD = 80;
constexpr int kRectWin = 14;

struct WindowRect {
  const bf16* y;      // [N, T, 3C]
  const bf16* a;      // [N, T, H*W]
  const bf16* bb;     // [N, T, H*W]
  const bf16* pad_k;  // [halves, H, P, hd + 2W]; only [.., 0, 0:hd] is read
  const bf16* pad_v;  // [halves, H, hd]
  bf16* o;            // [N, T, C]
  int Sq, Sk, H;      // T real rows; W*W logical keys
  int q_offset;
  bool causal;
  float scale;
  int n_first;        // windows of the first geometry
  int rows0, cols0, rows1, cols1;
  int pad_k_head;     // elements between two heads' pad_k tables: P * (hd + 2W)

  __device__ int half(int inst) const { return inst / H >= n_first ? 1 : 0; }
  __device__ size_t row(int inst, int s) const {
    return static_cast<size_t>(inst / H) * Sq + s;
  }
  __device__ const bf16* q_row(int inst, int s) const {
    return y + row(inst, s) * (3 * H * kRectHD) + (inst % H) * kRectHD;
  }
  // The token row of logical key position t, or -1 for a pad position.
  __device__ int token(int inst, int t) const {
    const int hf = half(inst);
    const int rows = hf ? rows1 : rows0, cols = hf ? cols1 : cols0;
    const int ka = t / kRectWin, kb = t % kRectWin;
    return ka < rows && kb < cols ? ka * cols + kb : -1;
  }
  __device__ const bf16* k_row(int inst, int t) const {
    const int s = token(inst, t);
    if (s >= 0) return q_row(inst, s) + H * kRectHD;
    return pad_k + static_cast<size_t>(half(inst) * H + inst % H) * pad_k_head;
  }
  __device__ const bf16* v_row(int inst, int t) const {
    const int s = token(inst, t);
    if (s >= 0) return q_row(inst, s) + 2 * H * kRectHD;
    return pad_v + (half(inst) * H + inst % H) * kRectHD;
  }
  __device__ bf16* o_row(int inst, int s) const {
    return o + row(inst, s) * (H * kRectHD) + (inst % H) * kRectHD;
  }
  // DOTS_I8: whether logical key t is a pad position, and the k row every
  // pad key of the instance shares.
  static constexpr bool kPadKeys = true;
  __device__ bool pad_key(int inst, int t) const { return token(inst, t) < 0; }
  __device__ const bf16* pad_k_row(int inst) const {
    return pad_k + static_cast<size_t>(half(inst) * H + inst % H) * pad_k_head;
  }
  __device__ int key_limit(int) const { return Sk; }
  __device__ float bias_a(int inst, int s, int j) const {
    return __bfloat162float(
        a[row(inst, s) * (H * kRectWin) + (inst % H) * kRectWin + kRectWin - 1 - j]);
  }
  __device__ float bias_b(int inst, int s, int j) const {
    return __bfloat162float(
        bb[row(inst, s) * (H * kRectWin) + (inst % H) * kRectWin + kRectWin - 1 - j]);
  }
};

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
  using namespace ullava;
  WindowRect p{static_cast<const bf16*>(y),
               static_cast<const bf16*>(a),
               static_cast<const bf16*>(b),
               static_cast<const bf16*>(pad_k),
               static_cast<const bf16*>(pad_v),
               static_cast<bf16*>(o),
               T, kRectWin * kRectWin, H, 0, false, scale,
               n_first, rows0, cols0, rows1, cols1, P * (kRectHD + 2 * kRectWin)};
  return launch_flash<kRectHD, kRectWin>(p, N * H, static_cast<cudaStream_t>(stream));
}

// The dots_i8 form: int8 scores over the real keys, the pad keys' scores
// unquantized, bf16 P V. Arguments as above.
ULLAVA_EXPORT int ullava_fused_window_attention_rect_i8(const void* y, const void* a,
                                                        const void* b, const void* pad_k,
                                                        const void* pad_v, void* o, int N, int H,
                                                        int T, int P, int n_first, int rows0,
                                                        int cols0, int rows1, int cols1,
                                                        float scale, void* stream) {
  using namespace ullava;
  WindowRect p{static_cast<const bf16*>(y),
               static_cast<const bf16*>(a),
               static_cast<const bf16*>(b),
               static_cast<const bf16*>(pad_k),
               static_cast<const bf16*>(pad_v),
               static_cast<bf16*>(o),
               T, kRectWin * kRectWin, H, 0, false, scale,
               n_first, rows0, cols0, rows1, cols1, P * (kRectHD + 2 * kRectWin)};
  return launch_flash<kRectHD, kRectWin, WindowRect, false, true>(
      p, N * H, static_cast<cudaStream_t>(stream));
}
