// flash_attention_fwd_bsh (K2): causal flash attention forward over
// row-major [B, S, H, hd] q/k/v with per-batch kv_lens and a static
// q_offset (the training forward with lse, K15, is flash_fwd_sm90.cu).
//
// Replaces: ullava_tpu/ops/attention.py:354 flash_attention_fwd_bsh
// (Pallas, lane-sliced head groups over the native layout; the serving
// primal).
//
// Bound on the card: at the serving prefill shape (B=4, S=320, H=32,
// hd=128) a layer moves ~42 MB (q, k, v read once, o written once) and
// does ~3.4 GFLOP of causal products: 13 us of HBM time against 3.4 us
// of bf16 tensor-core time, so bytes bound K2.
//
// K2 also runs at head_dim 64 (`ullava_flash_attention_fwd_bsh_hd64`): the
// CLIP ViT-L/14 tower's attention under `attn_impl="flash"` (16 heads of
// 64 over the 257 tokens padded to 264, kv_lens 257, not causal; the TPU
// kernel's own function at that width). At B=16 a layer moves ~35 MB and
// does ~4.4 GFLOP: 10 us of HBM time against 4.5 us of bf16 tensor-core
// time, so bytes bound it.
//
// Design: the shared online-softmax core (flash_core.cuh), one block per
// (b, h, 64-row q tile). q/k/v rows are read in place with the head
// stride, so no [B,H,S,hd] staging copy exists (the same point as the
// TPU kernel's lane slices). The key loop stops at min(kv_len[b], causal
// bound), which is the causal block skip. GQA reads k/v head
// h / (H / Hkv).
#include "flash_core.cuh"

namespace ullava {

template <int HD_>
struct AttnBSH {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* kv_lens;
  int Sq, Sk, H, Hkv, q_offset;
  bool causal;
  float scale;
  static constexpr int HD = HD_;

  __device__ const bf16* q_row(int inst, int s) const {
    const int b = inst / H, h = inst % H;
    return q + ((static_cast<size_t>(b) * Sq + s) * H + h) * HD;
  }
  __device__ const bf16* k_row(int inst, int t) const {
    const int b = inst / H, h = inst % H;
    return k + ((static_cast<size_t>(b) * Sk + t) * Hkv + h / (H / Hkv)) * HD;
  }
  __device__ const bf16* v_row(int inst, int t) const {
    const int b = inst / H, h = inst % H;
    return v + ((static_cast<size_t>(b) * Sk + t) * Hkv + h / (H / Hkv)) * HD;
  }
  __device__ bf16* o_row(int inst, int s) const {
    const int b = inst / H, h = inst % H;
    return o + ((static_cast<size_t>(b) * Sq + s) * H + h) * HD;
  }
  __device__ int key_limit(int inst) const { return min(Sk, kv_lens[inst / H]); }
  __device__ float bias_a(int, int, int) const { return 0.f; }
  __device__ float bias_b(int, int, int) const { return 0.f; }
};

}  // namespace ullava

// q, o: [B, Sq, H, 128] bf16; k, v: [B, Sk, Hkv, 128] bf16; kv_lens [B] int32.
ULLAVA_EXPORT int ullava_flash_attention_fwd_bsh(
    const void* q, const void* k, const void* v, const void* kv_lens, void* o,
    int B, int Sq, int Sk, int H, int Hkv, int causal, int q_offset, float scale,
    void* stream) {
  ullava::AttnBSH<128> p{static_cast<const ullava::bf16*>(q),
                         static_cast<const ullava::bf16*>(k),
                         static_cast<const ullava::bf16*>(v),
                         static_cast<ullava::bf16*>(o),
                         static_cast<const int*>(kv_lens),
                         Sq, Sk, H, Hkv, q_offset, causal != 0, scale};
  return ullava::launch_flash<128, 0>(p, B * H, static_cast<cudaStream_t>(stream));
}

// As above at head_dim 64: q, o [B, Sq, H, 64], k, v [B, Sk, Hkv, 64].
ULLAVA_EXPORT int ullava_flash_attention_fwd_bsh_hd64(
    const void* q, const void* k, const void* v, const void* kv_lens, void* o,
    int B, int Sq, int Sk, int H, int Hkv, int causal, int q_offset, float scale,
    void* stream) {
  ullava::AttnBSH<64> p{static_cast<const ullava::bf16*>(q),
                        static_cast<const ullava::bf16*>(k),
                        static_cast<const ullava::bf16*>(v),
                        static_cast<ullava::bf16*>(o),
                        static_cast<const int*>(kv_lens),
                        Sq, Sk, H, Hkv, q_offset, causal != 0, scale};
  return ullava::launch_flash<64, 0>(p, B * H, static_cast<cudaStream_t>(stream));
}
