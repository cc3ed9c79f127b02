// flash_attention_fwd_lse (K15): the training forward of causal flash
// attention over row-major [B, S, H, 128] q/k/v with per-batch kv_lens and
// a static q_offset, writing o and each row's logsumexp for the backward
// (K16, K17 in flash_attention_bwd.cu), built for Hopper (sm_90a) on
// wgmma and TMA.
//
// Replaces: ullava_tpu/ops/attention.py:173 flash_attention_fwd (kernel
// _flash_kernel :84-170, pallas_call :237; the training forward rule,
// which transposes q/k/v to [B, H, S, hd] first and returns lse as
// [B, H, Sq, 8]).
//
// Bound on the card at the stage-1 shape ([4, 1024, 32, 128], causal,
// kv_lens 1024/1000/777/513): q and the k, v rows below kv_lens (3314 of
// 4096 a head) read once and o, lse written once are 121.9 MB, 0.0364 ms
// at 3.35 TB/s; the live causal products are 3.4e10 FLOP, 0.035 ms at the
// bf16 peak. Bytes bound it, by a little; each query tile reads its
// (b, h)'s K and V again, from L2 where the block order keeps them there.
//
// Design: the shared wgmma + TMA forward (flash_fwd_sm90.cuh, which K2
// also runs) at head dim 128 with the lse store: a producer warpgroup
// feeding a three-stage K/V ring by TMA, two consumer warpgroups of 64
// query rows in ping-pong, heavy-first block order. The deliberate bugs
// `chip_smoke.py` builds into copies of this source (ULLAVA_MUTANT_LSE_NO_LOG,
// ULLAVA_MUTANT_CAUSAL_SHIFT) are the header's.
#include "flash_fwd_sm90.cuh"

// q, o: [B, Sq, H, 128] bf16; k, v: [B, Sk, Hkv, 128] bf16; kv_lens [B]
// int32; lse: [B, H, Sq] f32, m + log l of each row (1e30 where no key is
// live).
ULLAVA_EXPORT int ullava_flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, const void* kv_lens, void* o, void* lse,
    int B, int Sq, int Sk, int H, int Hkv, int causal, int q_offset, float scale,
    void* stream) {
  return ullava::sm90::flash::launch_fwd<128, true>(
      q, k, v, kv_lens, o, static_cast<float*>(lse), B, Sq, Sk, H, Hkv, causal, q_offset, scale,
      static_cast<cudaStream_t>(stream));
}
