// fused_window_attention_packed / fused_global_attention_packed: SAM ViT
// attention on the packed head-major layout. `pack_sam_attention` pads
// each head's q/k/v columns of the qkv projection to hp = 128 lanes, so
// the projection output y [N, S, 3*H*hp] holds head h's q, k and v as the
// 128-lane blocks (part*H + h)*hp, part 0/1/2; the attention output is
// [N, S, H*hp] with head h at h*hp, and the packed proj weight has zero
// rows under the pad lanes.
//
// Replaces: ullava_tpu/ops/sam_attention.py:826 fused_window_attention_packed
// (Pallas, kernel _packed_window_kernel :791) and :920
// fused_global_attention_packed (kernel _packed_global_kernel :867).
//
// Bound on the card, at a ViT-H encode at B=4 (H = 16, hp = 128):
//   - a window block (N = 100 windows, S = 196) reads the 80 real lanes of
//     q, k and v (151 MB of y's 241) and the two bias tensors (17.6 MB)
//     and writes 80 MB (pad lanes included): ~0.074 ms of HBM time, against
//     19.7 GFLOP of products over the real lanes (~0.02 ms): bytes bound it;
//   - a global block (B = 4, S = 4096) does 344 GFLOP of products over the
//     80 real lanes (~0.35 ms) against ~0.2 GB of traffic (~0.06 ms):
//     operations bound it; at one ViT-L image (B = 1, 16 heads of 64 real
//     lanes) 68.7 GFLOP, ~0.069 ms.
//
// Design: K19 (the window form) is a problem type of window_whole.cuh's
// body (one block per (window, head) over all 196 query rows, every score
// row whole in registers, K and V loaded once, the next tile's Q and bias
// rows prefetched with cp.async), instantiated at the real head width HD
// (`head_dim`: 64 for ViT-L and ViT-B, 80 for ViT-H), 4 warps a (window,
// head) as K3. The packed layout's pad lanes are zero by construction
// (ullava_tpu/ops/sam_attention.py:785-787), so the kernel reads only the
// HD real lanes of each q/k/v 128-lane block, in place at stride 3*H*hp,
// and writes the output's real lanes at stride H*hp and its
// hp - HD pad lanes as zeros: the same function on every input the packed
// layout produces, with no head split or merge copy. The bias terms arrive
// raw, [N, H, S, W] (head-second, as the packed kernels block on them), in
// natural column order, and are added after the scale: s = q.k * scale +
// A[s][t / W] + Bb[s][t % W], fp32 exponentials, as in both TPU kernels.
// Each form rounds P where its TPU kernel does: the window form normalizes
// P before rounding it to bf16 for P V (:818-822); the global form (K20) is
// online (m, l, acc; acc / l at the end) and runs on the wgmma + TMA
// global core (global_sm90.cuh) as the problem type PackedGlobal<HD>: its
// q/k/v the HD real lanes of the 128-lane blocks of the view {d, part * H +
// h, row, image} (head stride 256 bytes; at hd 80 TMA fills lanes 80-127
// of the second box with zeros), its bias rows the view {j, s, h, image},
// its output's pad lanes zeros from 16-byte stores of the core's epilogue.
// At hd 64 it runs the core's three-warpgroup B1 schedule (192-row query
// tiles), at hd 80 the two-warpgroup one.
//
// Compiled with ULLAVA_MUTANT_PACKED_BIAS_PRESCALED both forms add the
// bias before the scale (as if it arrived pre-scaled by 1/scale), with
// ULLAVA_MUTANT_PACKED_HEAD_OFFSET both read k one head over, and with
// ULLAVA_MUTANT_PACKED_K_ACROSS_BLOCK both read their k rows from lane
// 128 - HD / 2 of the block, across its 128-lane boundary: deliberate bugs
// that only `chip_smoke.py` and the card tests build, to show that the
// gates catch them (window_whole.cuh and global_sm90.cuh hold the others:
// pad lanes left unwritten, the A term, the B1 and tail-tile bugs).
#include "global_sm90.cuh"
#include "window_whole.cuh"

namespace ullava {

constexpr int kPackHP = 128;
constexpr int kPackWin = 14;

// K19's layout at HD real lanes of each 128-lane block.
template <int HD>
struct PackedAttn {
  const bf16* y;   // [N, S, 3*H*hp]
  const bf16* a;   // [N, H, S, W] raw
  const bf16* bb;  // [N, H, S, W] raw
  bf16* o;         // [N, S, H*hp]
  int Sq, H;
  float scale;
  static constexpr bool kBiasAfterScale = true;
  static constexpr bool kPadKeys = false;
  static constexpr bool kBiasRaw = false;
  static constexpr int kOutLanes = kPackHP;

  // inst = n * H + h
  __device__ size_t row(int inst, int s) const {
    return static_cast<size_t>(inst / H) * Sq + s;
  }
  __device__ const bf16* q_row(int inst, int s) const {
    return y + row(inst, s) * (3 * H * kPackHP) + (inst % H) * kPackHP;
  }
  __device__ const bf16* k_row(int inst, int t) const {
#ifdef ULLAVA_MUTANT_PACKED_HEAD_OFFSET
    return y + row(inst, t) * (3 * H * kPackHP) + (H + (inst + 1) % H) * kPackHP;
#endif
#ifdef ULLAVA_MUTANT_PACKED_K_ACROSS_BLOCK
    return q_row(inst, t) + H * kPackHP + (kPackHP - HD / 2);  // lanes 128 - HD / 2 on
#endif
    return q_row(inst, t) + H * kPackHP;
  }
  __device__ const bf16* v_row(int inst, int t) const {
    return q_row(inst, t) + 2 * H * kPackHP;
  }
  __device__ bf16* o_row(int inst, int s) const {
    return o + row(inst, s) * (H * kPackHP) + (inst % H) * kPackHP;
  }
  // The W raw terms of row s (term 0: A, 1: Bb), natural columns.
  __device__ const bf16* bias_row(int inst, int s, int term) const {
    return (term ? bb : a) + (static_cast<size_t>(inst) * Sq + s) * kPackWin;
  }
};

template <int HD>
int launch_window_packed(const void* y, const void* a, const void* b, void* o, int N, int H,
                         float scale, void* stream) {
  const PackedAttn<HD> p{static_cast<const bf16*>(y), static_cast<const bf16*>(a),
                         static_cast<const bf16*>(b), static_cast<bf16*>(o),
                         kPackWin * kPackWin, H, scale};
  return launch_window_whole<HD, kPackWin>(p, N * H, static_cast<cudaStream_t>(stream));
}

// K20's layout for the global core: the HD real lanes of each 128-lane
// q/k/v block (the view's head stride 256 bytes), the raw bias terms
// [B, H, S, 64] as the view {j, s, h, b}, added after the scale; the
// output's head blocks 128 lanes wide, its pad lanes written as zeros.
template <int HD>
struct PackedGlobal {
  static constexpr int kHD = HD;
  static constexpr int kLanes = kPackHP;
  static constexpr bool kBiasAfterScale = true;
  static constexpr bool kBiasRaw = false;
  static constexpr int kQkvHeads = 3;
  __device__ static void bias_coord(int b, int h, int q0, int (&c)[4]) {
    c[0] = 0;
    c[1] = q0;
    c[2] = h;
    c[3] = b;
  }
  __device__ static int k_head(int h, int H) {
#ifdef ULLAVA_MUTANT_PACKED_HEAD_OFFSET
    return H + (h + 1) % H;
#else
    return H + h;
#endif
  }
  __device__ static int v_head(int h, int H) { return 2 * H + h; }
  static bool make_bias_map(CUtensorMap* map, const void* t, int B, int H, int rows) {
    const cuuint64_t dims[4] = {glob::kW, glob::kS, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {128, 128ull * glob::kS, 128ull * glob::kS * H};
    const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
    return sm90::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, t, dims, strides, box,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  }
};

template <int HD>
int launch_global_packed(const void* y, const void* a, const void* b, void* o, int B, int H,
                         float scale, void* stream) {
  const glob::Params p{static_cast<bf16*>(o), nullptr, nullptr, B, H, scale * glob::kLog2e,
                       1.f / scale};
  const bf16* k = static_cast<const bf16*>(y);
#ifdef ULLAVA_MUTANT_PACKED_K_ACROSS_BLOCK
  k += kPackHP - HD / 2;  // k's view from lane 128 - HD / 2 of each block on
#endif
  return glob::launch_global<PackedGlobal<HD>, false, false>(
      y, k, y, a, b, nullptr, nullptr, p, static_cast<cudaStream_t>(stream));
}

}  // namespace ullava

// y: [N, 196, 3*H*128] bf16; a, b: [N, H, 196, 14] bf16; o: [N, 196, H*128];
// head_dim 64 or 80, the real lanes of each 128-lane block (any other is
// refused with cudaErrorInvalidValue).
ULLAVA_EXPORT int ullava_fused_window_attention_packed(const void* y, const void* a,
                                                       const void* b, void* o, int N, int H,
                                                       int head_dim, float scale, void* stream) {
  using namespace ullava;
  if (head_dim == 64)
    return launch_window_packed<64>(y, a, b, o, N, H, scale, stream);
  if (head_dim == 80)
    return launch_window_packed<80>(y, a, b, o, N, H, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// y: [B, 4096, 3*H*128] bf16; a, b: [B, H, 4096, 64] bf16; o: [B, 4096, H*128];
// head_dim 64 or 80, the real lanes of each 128-lane block, which alone
// are loaded and contracted (any other is refused with
// cudaErrorInvalidValue).
ULLAVA_EXPORT int ullava_fused_global_attention_packed(const void* y, const void* a,
                                                       const void* b, void* o, int B, int H,
                                                       int head_dim, float scale, void* stream) {
  using namespace ullava;
  if (head_dim == 64) return launch_global_packed<64>(y, a, b, o, B, H, scale, stream);
  if (head_dim == 80) return launch_global_packed<80>(y, a, b, o, B, H, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the global form's kernel (K20) at head_dim 64 or 80.
ULLAVA_EXPORT int ullava_global_attention_packed_attrs(int head_dim, int* out) {
  using namespace ullava;
  if (head_dim == 64) return glob::attrs<PackedGlobal<64>, false, false>(out);
  if (head_dim == 80) return glob::attrs<PackedGlobal<80>, false, false>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the window form's kernel (K19) at head_dim 64 or 80.
ULLAVA_EXPORT int ullava_window_attention_packed_attrs(int head_dim, int* out) {
  using namespace ullava;
  if (head_dim == 64) return window_whole_attrs<64, kPackWin, PackedAttn<64>>(out);
  if (head_dim == 80) return window_whole_attrs<80, kPackWin, PackedAttn<80>>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
