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
//   - a window block (N = 100 windows, S = 196) reads y (241 MB) and the
//     two bias tensors (17.6 MB) and writes 80 MB: ~0.10 ms of HBM time,
//     against 31.5 GFLOP of products over the 128 lanes (~0.03 ms): bytes
//     bound it;
//   - a global block (B = 4, S = 4096) does 550 GFLOP of products over the
//     128 lanes (~0.56 ms; 0.35 ms over the 80 real lanes) against ~0.3 GB
//     of traffic (~0.09 ms): operations bound it. The kernel contracts all
//     128 lanes; the pad lanes are zero only by the weights' construction.
//
// Design: K19 (the window form) reads q/k/v rows in place at stride
// 3*H*hp through one accessor over the layout, at HD = 128 (instance =
// window times head), and writes the output at stride H*hp, so no head
// split or merge copy exists. The bias terms arrive raw, [N, H, S, W]
// (head-second, as the packed kernels block on them), and are added after
// the scale: s = q.k * scale + A[s][t / W] + Bb[s][t % W], fp32
// exponentials, as in both TPU kernels. Each form rounds P where its TPU
// kernel does: the window form normalizes P before rounding it to bf16 for
// P V (:818-822) and runs on window_whole.cuh (one block per (window,
// head) over all 196 query rows, every score row whole in registers, K
// and V loaded once); the global form (K20) is online (m, l, acc; acc / l
// at the end) and runs on the wgmma + TMA global core (global_sm90.cuh),
// one block per (image, head, 128-row q tile), its q/k/v the 128-lane
// blocks of the view {d, part * H + h, row, image} and its bias rows the
// view {j, s, h, image}.
//
// Compiled with ULLAVA_MUTANT_PACKED_BIAS_PRESCALED both forms add the
// bias before the scale (as if it arrived pre-scaled by 1/scale), and with
// ULLAVA_MUTANT_PACKED_HEAD_OFFSET both read k one head over: deliberate
// bugs that only `chip_smoke.py` builds, to show that the gates catch them
// (window_whole.cuh holds the window form's own third one, the global
// core the A-term one).
#include "global_sm90.cuh"
#include "window_whole.cuh"

namespace ullava {

constexpr int kPackHP = 128;

template <int W>
struct PackedAttn {
  const bf16* y;   // [N, S, 3*H*hp]
  const bf16* a;   // [N, H, S, W] raw
  const bf16* bb;  // [N, H, S, W] raw
  bf16* o;         // [N, S, H*hp]
  int Sq, Sk, H;
  int q_offset;
  bool causal;
  float scale;

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
#else
    return q_row(inst, t) + H * kPackHP;
#endif
  }
  __device__ const bf16* v_row(int inst, int t) const {
    return q_row(inst, t) + 2 * H * kPackHP;
  }
  __device__ bf16* o_row(int inst, int s) const {
    return o + row(inst, s) * (H * kPackHP) + (inst % H) * kPackHP;
  }
  __device__ int key_limit(int) const { return Sk; }
  __device__ float bias_a(int inst, int s, int j) const {
    return __bfloat162float(a[(static_cast<size_t>(inst) * Sq + s) * W + j]);
  }
  __device__ float bias_b(int inst, int s, int j) const {
    return __bfloat162float(bb[(static_cast<size_t>(inst) * Sq + s) * W + j]);
  }
  static constexpr bool kBiasAfterScale = true;
};

int launch_window_packed(const void* y, const void* a, const void* b, void* o, int N, int H,
                         float scale, void* stream) {
  constexpr int W = 14;
  PackedAttn<W> p{static_cast<const bf16*>(y), static_cast<const bf16*>(a),
                  static_cast<const bf16*>(b), static_cast<bf16*>(o),
                  W * W, W * W, H, 0, false, scale};
  return launch_window_whole<kPackHP, W>(p, N * H, static_cast<cudaStream_t>(stream));
}

// K20's layout for the global core: the raw bias terms [B, H, S, 64] as the
// view {j, s, h, b}, added after the scale.
struct PackedGlobal {
  static constexpr int kHD = kPackHP;
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
  static bool make_bias_map(CUtensorMap* map, const void* t, int B, int H) {
    const cuuint64_t dims[4] = {glob::kW, glob::kS, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {128, 128ull * glob::kS, 128ull * glob::kS * H};
    const cuuint32_t box[4] = {64, 128, 1, 1};
    return sm90::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, t, dims, strides, box,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  }
};

}  // namespace ullava

// y: [N, 196, 3*H*128] bf16; a, b: [N, H, 196, 14] bf16; o: [N, 196, H*128].
ULLAVA_EXPORT int ullava_fused_window_attention_packed(const void* y, const void* a,
                                                       const void* b, void* o, int N, int H,
                                                       float scale, void* stream) {
  return ullava::launch_window_packed(y, a, b, o, N, H, scale, stream);
}

// y: [B, 4096, 3*H*128] bf16; a, b: [B, H, 4096, 64] bf16; o: [B, 4096, H*128].
ULLAVA_EXPORT int ullava_fused_global_attention_packed(const void* y, const void* a,
                                                       const void* b, void* o, int B, int H,
                                                       float scale, void* stream) {
  using namespace ullava;
  const glob::Params p{static_cast<bf16*>(o), nullptr, nullptr, B, H, scale * glob::kLog2e,
                       1.f / scale};
  return glob::launch_global<PackedGlobal, false, false>(y, y, y, a, b, nullptr, nullptr, p,
                                                         static_cast<cudaStream_t>(stream));
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the window form's kernel (K19).
ULLAVA_EXPORT int ullava_window_attention_packed_attrs(int* out) {
  return ullava::window_whole_attrs<ullava::kPackHP, 14, ullava::PackedAttn<14>>(out);
}
