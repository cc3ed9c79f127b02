// prefill_quantize_write: quantize a prefill's K/V rows per (row, kv
// head) and write them into positions [0, S) of one layer of the stacked
// int8 cache, in place.
//
// Replaces: ullava_tpu/ops/decode_attention.py:508 prefill_quantize_write
// (kernel _prefill_qwrite_kernel, :461), which DMAs (batch, seq-chunk)
// blocks into the cache through aliased output windows whose index maps
// take the layer from scalar prefetch.
//
// Bound on the card: bytes. Per element it reads 2 B and writes 1 B, plus
// one f32 scale per head_dim elements.
//
// Design: one warp per (tensor, row, head). A lane owns 4 contiguous
// elements (one 8-byte load, one 4-byte store) of each 128-wide stretch
// of the head, at most two stretches (head_dim <= 256), kept in
// registers between the abs-max shuffle reduction and the quantization.
// The math is that of quantize_kv_rows: scale = max(amax, 1e-12) / 127 as
// an IEEE division, x / scale, round half to even, clip to +-127. The
// destination offset is computed from the layer index, the batch row and
// the cache's own length, so nothing of the cache is copied or sliced and
// rows [S, maxS) and other layers are never addressed.
#include "common.cuh"

namespace ullava {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxStretches = 2;  // head_dim <= 256

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
kv_quant_write_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                      int8_t* __restrict__ cache_k, int8_t* __restrict__ cache_v,
                      float* __restrict__ k_scale, float* __restrict__ v_scale,
                      long long heads_total,  // B * S * Hkv
                      int S, int Hkv, int hd, int maxS, long long layer_row0) {
  const int lane = threadIdx.x & 31;
  const long long item =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= heads_total) return;  // whole warps leave together
  const bool is_v = blockIdx.y == 1;
  const bf16* src = (is_v ? v : k) + item * hd;
  const int head = static_cast<int>(item % Hkv);
  const long long row = item / Hkv;  // b * S + s
  const long long b = row / S;
  const int s = static_cast<int>(row % S);
  const long long dst_row = layer_row0 + b * maxS + s;
  int8_t* dst = (is_v ? cache_v : cache_k) + (dst_row * Hkv + head) * hd;
  float* dst_scale = (is_v ? v_scale : k_scale) + dst_row * Hkv + head;

  float x[kMaxStretches][4];
  float am = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxStretches; ++j) {
    const int d = j * 128 + lane * 4;
    if (d < hd) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src + d);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 lo = __bfloat1622float2(h[0]);
      const float2 hi = __bfloat1622float2(h[1]);
      x[j][0] = lo.x; x[j][1] = lo.y; x[j][2] = hi.x; x[j][3] = hi.y;
#pragma unroll
      for (int i = 0; i < 4; ++i) am = fmaxf(am, fabsf(x[j][i]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
  const float scale = fmaxf(am, 1e-12f) / 127.0f;
#pragma unroll
  for (int j = 0; j < kMaxStretches; ++j) {
    const int d = j * 128 + lane * 4;
    if (d < hd) {
      uint32_t w = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int q = __float2int_rn(x[j][i] / scale);
        q = max(-127, min(127, q));
        w |= (static_cast<uint32_t>(q) & 0xffu) << (8 * i);
      }
      *reinterpret_cast<uint32_t*>(dst + d) = w;
    }
  }
  if (lane == 0) *dst_scale = scale;
}

}  // namespace ullava

// k, v: [B, S, Hkv, hd] bf16; cache_k, cache_v: [L, B, maxS, Hkv*hd] int8;
// k_scale, v_scale: [L, B, maxS, Hkv] f32. hd % 4 == 0, hd <= 256,
// S <= maxS, 0 <= layer < L (checked by the wrapper).
ULLAVA_EXPORT int ullava_prefill_quantize_write(const void* k, const void* v,
                                                void* cache_k, void* cache_v,
                                                void* k_scale, void* v_scale,
                                                int B, int S, int Hkv, int hd,
                                                int maxS, int layer, void* stream) {
  const long long heads_total = static_cast<long long>(B) * S * Hkv;
  if (heads_total > 0) {
    const long long blocks =
        (heads_total + ullava::kWarpsPerBlock - 1) / ullava::kWarpsPerBlock;
    const dim3 grid(static_cast<unsigned>(blocks), 2);
    ullava::kv_quant_write_kernel<<<grid, ullava::kWarpsPerBlock * 32, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const ullava::bf16*>(k), static_cast<const ullava::bf16*>(v),
        static_cast<int8_t*>(cache_k), static_cast<int8_t*>(cache_v),
        static_cast<float*>(k_scale), static_cast<float*>(v_scale), heads_total, S,
        Hkv, hd, maxS, static_cast<long long>(layer) * B * maxS);
  }
  return static_cast<int>(cudaGetLastError());
}
