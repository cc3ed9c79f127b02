// flash_attention_fwd_bsh (K2): flash attention forward over row-major
// [B, S, H, hd] q/k/v with per-batch kv_lens, a static q_offset, causal or
// not, and GQA (k/v head h / (H / Hkv)); no logsumexp. Two entries: head
// dim 128 (the LLaMA prefill, causal) and 64 (CLIP ViT-L/14 under
// `attn_impl="flash"`: 16 heads of 64 over the 257 tokens padded to 264,
// kv_lens 257, not causal).
//
// Replaces: ullava_tpu/ops/attention.py:354 flash_attention_fwd_bsh
// (Pallas, lane-sliced head groups over the native layout; the serving
// primal).
//
// Bound on the card: at the serving prefill shape (B=4, S=320, H=32,
// hd=128, ragged kv_lens) q and o and the live k, v rows are 40 MB, 12 us
// at 3.35 TB/s, against 3.4 GFLOP of live causal products, 3.4 us at the
// bf16 peak; at CLIP's [16, 264, 16, 64] 34 MB (10 us) against 4.4 GFLOP
// (4.5 us). Bytes bound both.
//
// Design: the wgmma + TMA forward that K15 runs (flash_fwd_sm90.cuh)
// without its lse store, instantiated at both head dims: one block per
// 128-row query tile of a (b, h) in heavy-first order, a producer
// warpgroup feeding a three-stage K/V ring by TMA (rows past S and keys
// past Sk zero-filled), two consumer warpgroups in ping-pong on
// wgmma.m64n128k16 (Q K^T) and m64n64k16 (P V from registers). The key loop
// stops at min(kv_len[b], causal bound + q_offset) (the causal block
// skip), and every tile that holds the kv_len edge is masked at kv_len
// (rows between kv_len and Sk are real data). A row with no live key
// writes zeros.
//
// The deliberate bugs of the shared header (ULLAVA_MUTANT_CAUSAL_SHIFT,
// ULLAVA_MUTANT_KV_EDGE_TILE_END) are built into copies of this source by
// `chip_smoke.py` for K2's gates.
#include "flash_fwd_sm90.cuh"

// q, o: [B, Sq, H, 128] bf16; k, v: [B, Sk, Hkv, 128] bf16; kv_lens [B] int32.
ULLAVA_EXPORT int ullava_flash_attention_fwd_bsh(
    const void* q, const void* k, const void* v, const void* kv_lens, void* o,
    int B, int Sq, int Sk, int H, int Hkv, int causal, int q_offset, float scale,
    void* stream) {
  return ullava::sm90::flash::launch_fwd<128, false>(
      q, k, v, kv_lens, o, nullptr, B, Sq, Sk, H, Hkv, causal, q_offset, scale,
      static_cast<cudaStream_t>(stream));
}

// As above at head_dim 64: q, o [B, Sq, H, 64], k, v [B, Sk, Hkv, 64].
ULLAVA_EXPORT int ullava_flash_attention_fwd_bsh_hd64(
    const void* q, const void* k, const void* v, const void* kv_lens, void* o,
    int B, int Sq, int Sk, int H, int Hkv, int causal, int q_offset, float scale,
    void* stream) {
  return ullava::sm90::flash::launch_fwd<64, false>(
      q, k, v, kv_lens, o, nullptr, B, Sq, Sk, H, Hkv, causal, q_offset, scale,
      static_cast<cudaStream_t>(stream));
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the head-dim
// `hd` (64 or 128) kernel.
ULLAVA_EXPORT int ullava_flash_attention_fwd_bsh_attrs(int hd, int* out) {
  using namespace ullava::sm90::flash;
  return hd == 64 ? attrs<64, false>(out) : attrs<128, false>(out);
}
