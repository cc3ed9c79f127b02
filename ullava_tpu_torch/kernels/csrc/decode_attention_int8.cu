// decode_attention_int8_fused_write: one-token attention over the int8 KV
// cache that also writes the token's own K/V row; and decode_attention_int8,
// the same attention over the cache as it stands, which writes nothing.
//
// Replaces: ullava_tpu/ops/decode_attention.py:345
// decode_attention_int8_fused_write (kernel _fused_write_kernel, :221), and
// :143 decode_attention_int8 (kernel _kernel, :46).
//
// The TPU kernel turns the per-head dots into two MXU products through a
// block-diagonal copy of q and 0/1 expansion matrices, and re-emits the
// 8-row stripe around write_pos because its output windows are 8 rows
// tall. None of that is needed here: a warp dots int8 rows with q in
// registers, and the new row is a plain store. With the MXU products go
// their bf16 roundings of p * v_scale and of the denominator: both stay
// fp32 here.
//
// Bound on the card: bytes. A sample reads write_pos[b] rows of K and of V
// (1 B per element) and their scales once; q, the new rows and the output
// are a few KB. About 4 flops per byte read.
//
// Design: one block of 4 warps per (sample, q head); the kv head is
// h / (H / Hkv), so GQA needs no expansion. hd/16 lanes share a cache
// row (16 int8 = one 16-byte load per lane), so a warp covers
// 32 / (hd/16) positions per step and the 4 warps stride over the
// positions. "Position" write_pos[b] is the current token: its data comes
// from the quantized new row instead of the cache, so the cache rows at
// and after write_pos[b] are never read (the staleness mask) and the
// current token is scored with the same arithmetic as a cached one.
//   pass 1  s[p] = (q . Kq[p]) * (k_scale[p] * scale)     -> shared memory
//   pass 2  block max, e = exp(s - m), block sum of e,
//           s[p] <- e * v_scale[p]                        (fp32)
//   pass 3  o[d] = sum_p s[p] * Vq[p, d], reduced over the lanes and warps
//           that share d; out = o / sum, rounded to bf16.
// The block of a kv head's first q head then stores the new K/V row and
// its two scales at write_pos[b]. Other blocks of this launch read rows
// below write_pos[b] only, so the store races with nothing. write_pos is
// read from device memory; a position outside [0, maxS) attends over the
// clamped range and stores nothing.
//
// decode_attention_int8 (second entry) is K8's read side without the
// write, in the arithmetic of its own TPU kernel, which differs from K8's:
// the mask is pos < kv_lens[b] (:121; a row with kv_lens <= 0 gives every
// position the same masked score, so a uniform average, as there); the
// scale folds into the fp32 key-scale multiply (:113-120); P is
// normalized before the product with the value scale is rounded to bf16,
// pv = bf16((e / l) * v_scale) (:122-125), and the output is the fp32 sum
// of pv * Vq rounded to bf16, with no division after it. Same grid, lanes
// and passes as above, and the same bound: bytes, the kv_lens[b] rows of
// K and V a sample and their scales. Compiled with
// ULLAVA_MUTANT_DECODE_NO_KV_LENS it attends over all maxS rows: a
// deliberate bug that only `chip_smoke.py` builds, to show that the gate
// catches it.
#include "row_quant.cuh"

namespace ullava {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// 16 int8 values against 16 floats.
__device__ inline float dot16(const int4& raw, const float (&f)[16]) {
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    acc += static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xff)) * f[i];
  return acc;
}

__global__ void __launch_bounds__(kThreads)
decode_attention_int8_kernel(
    const bf16* __restrict__ q,          // [B, H, hd]
    const int8_t* __restrict__ kq_new,   // [B, Hkv*hd]
    const float* __restrict__ ks_new,    // [B, Hkv]
    const int8_t* __restrict__ vq_new,   // [B, Hkv*hd]
    const float* __restrict__ vs_new,    // [B, Hkv]
    int8_t* cache_k, int8_t* cache_v,    // this layer: [B, maxS, Hkv*hd]
    float* k_scale, float* v_scale,      // this layer: [B, maxS, Hkv]
    const int* __restrict__ write_pos,   // [B]
    bf16* __restrict__ out,              // [B, H, hd]
    int H, int Hkv, int hd, int maxS, float scale) {
  extern __shared__ float smem[];
  float* sc = smem;                   // [maxS + 1]
  float* part = sc + maxS + 1;        // [kWarps, hd]
  float* scratch = part + kWarps * hd;  // [32], for the block reductions

  const int h = blockIdx.x, b = blockIdx.y;
  const int rep = H / Hkv;
  const int kvh = h / rep;
  const int Ckv = Hkv * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpp = hd / 16;     // lanes per position
  const int ppw = 32 / lpp;    // positions per warp step
  const int sub = lane / lpp;  // which of the warp's positions
  const int chunk = lane % lpp;  // which 16 dims of the head

  const int wp_raw = write_pos[b];
  const int wp = min(max(wp_raw, 0), maxS);  // rows [0, wp) are history
  const int n = wp + 1;                      // plus the current token

  const long long row0 = static_cast<long long>(b) * maxS;
  const long long head_off = static_cast<long long>(kvh) * hd + chunk * 16;
  const long long new_off = static_cast<long long>(b) * Ckv + head_off;

  float qf[16];
  {
    const bf16* qp = q + (static_cast<long long>(b) * H + h) * hd + chunk * 16;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qp + i));
      qf[i] = t.x;
      qf[i + 1] = t.y;
    }
  }

  // Pass 1: scores.
  for (int p0 = warp * ppw; p0 < n; p0 += kWarps * ppw) {
    const int p = p0 + sub;
    float d = 0.f;
    if (p < n) {
      const int8_t* src = p < wp ? cache_k + (row0 + p) * Ckv + head_off : kq_new + new_off;
      d = dot16(*reinterpret_cast<const int4*>(src), qf);
    }
    for (int o = lpp >> 1; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (p < n && chunk == 0) {
      const float ks = p < wp ? k_scale[(row0 + p) * Hkv + kvh] : ks_new[b * Hkv + kvh];
      sc[p] = d * (ks * scale);
    }
  }
  __syncthreads();

  // Pass 2: softmax numerators times the value scales, and the denominator.
  float m = -3.0e38f;
  for (int p = tid; p < n; p += kThreads) m = fmaxf(m, sc[p]);
  m = block_reduce<true>(m, scratch);
  float l = 0.f;
  for (int p = tid; p < n; p += kThreads) {
    const float e = expf(sc[p] - m);
    l += e;
    const float vs = p < wp ? v_scale[(row0 + p) * Hkv + kvh] : vs_new[b * Hkv + kvh];
    sc[p] = e * vs;
  }
  l = block_reduce<false>(l, scratch);  // its barriers also publish sc[]

  // Pass 3: weighted sum of the value rows.
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int p0 = warp * ppw; p0 < n; p0 += kWarps * ppw) {
    const int p = p0 + sub;
    if (p < n) {
      const int8_t* src = p < wp ? cache_v + (row0 + p) * Ckv + head_off : vq_new + new_off;
      const int4 raw = *reinterpret_cast<const int4*>(src);
      const int w[4] = {raw.x, raw.y, raw.z, raw.w};
      const float pw = sc[p];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        acc[i] += pw * static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xff));
    }
  }
  for (int o = lpp; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) part[warp * hd + chunk * 16 + i] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < hd; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) o += part[wi * hd + d];
    out[(static_cast<long long>(b) * H + h) * hd + d] = __float2bfloat16_rn(o / l);
  }

  // The new row, once per kv head.
  if (h % rep == 0 && wp_raw >= 0 && wp_raw < maxS) {
    const long long dst_row = row0 + wp_raw;
    for (int c = tid; c < 2 * lpp; c += kThreads) {
      const bool is_v = c >= lpp;
      const long long off = static_cast<long long>(kvh) * hd + (c % lpp) * 16;
      const int8_t* src = (is_v ? vq_new : kq_new) + static_cast<long long>(b) * Ckv + off;
      int8_t* dst = (is_v ? cache_v : cache_k) + dst_row * Ckv + off;
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    }
    if (tid == 0) {
      k_scale[dst_row * Hkv + kvh] = ks_new[b * Hkv + kvh];
      v_scale[dst_row * Hkv + kvh] = vs_new[b * Hkv + kvh];
    }
  }
}


// Masked score of the TPU kernel (-0.7 * the largest fp32).
constexpr float kDecodeNegInf = -0.7f * 3.4028234663852886e38f;

__global__ void __launch_bounds__(kThreads)
decode_attention_int8_read_kernel(
    const bf16* __restrict__ q,            // [B, H, hd]
    const int8_t* __restrict__ cache_k,    // this layer: [B, maxS, Hkv*hd]
    const int8_t* __restrict__ cache_v,
    const float* __restrict__ k_scale,     // this layer: [B, maxS, Hkv]
    const float* __restrict__ v_scale,
    const int* __restrict__ kv_lens,       // [B]
    bf16* __restrict__ out,                // [B, H, hd]
    int H, int Hkv, int hd, int maxS, float scale) {
  extern __shared__ float smem[];
  float* sc = smem;                     // [maxS]
  float* part = sc + maxS;              // [kWarps, hd]
  float* scratch = part + kWarps * hd;  // [32]

  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / Hkv);
  const int Ckv = Hkv * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpp = hd / 16, ppw = 32 / lpp;
  const int sub = lane / lpp, chunk = lane % lpp;

#ifdef ULLAVA_MUTANT_DECODE_NO_KV_LENS
  const int kvl = maxS;
#else
  const int kvl = kv_lens[b];
#endif
  const bool none = kvl <= 0;           // every position masked
  const int n = none ? maxS : min(kvl, maxS);  // positions past n have p = 0

  const long long row0 = static_cast<long long>(b) * maxS;
  const long long head_off = static_cast<long long>(kvh) * hd + chunk * 16;

  float qf[16];
  {
    const bf16* qp = q + (static_cast<long long>(b) * H + h) * hd + chunk * 16;
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qp + i));
      qf[i] = t.x;
      qf[i + 1] = t.y;
    }
  }

  // Pass 1: s[p] = (q . Kq[p]) * (k_scale[p] * scale).
  for (int p0 = warp * ppw; p0 < n; p0 += kWarps * ppw) {
    const int p = p0 + sub;
    float d = 0.f;
    if (p < n && !none)
      d = dot16(*reinterpret_cast<const int4*>(cache_k + (row0 + p) * Ckv + head_off), qf);
    for (int o = lpp >> 1; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
    if (p < n && chunk == 0)
      sc[p] = none ? kDecodeNegInf : d * (k_scale[(row0 + p) * Hkv + kvh] * scale);
  }
  __syncthreads();

  // Pass 2: e = exp(s - m), l = sum e, then pv = bf16((e / l) * v_scale).
  float m = -3.0e38f;
  for (int p = tid; p < n; p += kThreads) m = fmaxf(m, sc[p]);
  m = block_reduce<true>(m, scratch);
  float l = 0.f;
  for (int p = tid; p < n; p += kThreads) {
    const float e = expf(sc[p] - m);
    sc[p] = e;
    l += e;
  }
  l = block_reduce<false>(l, scratch);
  for (int p = tid; p < n; p += kThreads)
    sc[p] = __bfloat162float(__float2bfloat16_rn((sc[p] / l) * v_scale[(row0 + p) * Hkv + kvh]));
  __syncthreads();

  // Pass 3: o[d] = sum_p pv[p] * Vq[p, d] over the lanes and warps that share d.
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int p0 = warp * ppw; p0 < n; p0 += kWarps * ppw) {
    const int p = p0 + sub;
    if (p < n) {
      const int4 raw = *reinterpret_cast<const int4*>(cache_v + (row0 + p) * Ckv + head_off);
      const int w[4] = {raw.x, raw.y, raw.z, raw.w};
      const float pw = sc[p];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        acc[i] += pw * static_cast<float>(static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xff));
    }
  }
  for (int o = lpp; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) part[warp * hd + chunk * 16 + i] = acc[i];
  }
  __syncthreads();
  for (int d = tid; d < hd; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) o += part[wi * hd + d];
    out[(static_cast<long long>(b) * H + h) * hd + d] = __float2bfloat16_rn(o);
  }
}

}  // namespace ullava

// q, out: [B, 1, H, hd] bf16; kq_new, vq_new: [B, Hkv*hd] int8; ks_new,
// vs_new: [B, Hkv] f32; cache_k, cache_v: [L, B, maxS, Hkv*hd] int8;
// k_scale, v_scale: [L, B, maxS, Hkv] f32; write_pos: [B] int32.
// hd = 16 * 2^n <= 512, H % Hkv == 0, 0 <= layer < L and the shared
// memory need (maxS + 1 + 4*hd + 32 floats) <= 48 KB (checked by the
// wrapper).
ULLAVA_EXPORT int ullava_decode_attention_int8_fused_write(
    const void* q, const void* kq_new, const void* ks_new, const void* vq_new,
    const void* vs_new, void* cache_k, void* cache_v, void* k_scale, void* v_scale,
    const void* write_pos, void* out, int B, int H, int Hkv, int hd, int maxS,
    int layer, float scale, void* stream) {
  if (B > 0) {
    const long long rows = static_cast<long long>(layer) * B * maxS;
    const size_t smem =
        (static_cast<size_t>(maxS) + 1 + ullava::kWarps * hd + 32) * sizeof(float);
    const dim3 grid(H, B);
    ullava::decode_attention_int8_kernel<<<grid, ullava::kThreads, smem,
                                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const ullava::bf16*>(q), static_cast<const int8_t*>(kq_new),
        static_cast<const float*>(ks_new), static_cast<const int8_t*>(vq_new),
        static_cast<const float*>(vs_new),
        static_cast<int8_t*>(cache_k) + rows * Hkv * hd,
        static_cast<int8_t*>(cache_v) + rows * Hkv * hd,
        static_cast<float*>(k_scale) + rows * Hkv,
        static_cast<float*>(v_scale) + rows * Hkv,
        static_cast<const int*>(write_pos), static_cast<ullava::bf16*>(out), H, Hkv,
        hd, maxS, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, out: [B, 1, H, hd] bf16; cache_k, cache_v: [L, B, maxS, Hkv*hd] int8;
// k_scale, v_scale: [L, B, maxS, Hkv] f32; kv_lens: [B] int32. hd = 16 *
// 2^n <= 512, H % Hkv == 0, 0 <= layer < L and the shared memory need
// (maxS + 4*hd + 32 floats) <= 48 KB (checked by the wrapper).
ULLAVA_EXPORT int ullava_decode_attention_int8(const void* q, const void* cache_k,
                                               const void* cache_v, const void* k_scale,
                                               const void* v_scale, const void* kv_lens,
                                               void* out, int B, int H, int Hkv, int hd,
                                               int maxS, int layer, float scale, void* stream) {
  if (B > 0) {
    const long long rows = static_cast<long long>(layer) * B * maxS;
    const size_t smem = (static_cast<size_t>(maxS) + ullava::kWarps * hd + 32) * sizeof(float);
    const dim3 grid(H, B);
    ullava::decode_attention_int8_read_kernel<<<grid, ullava::kThreads, smem,
                                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const ullava::bf16*>(q),
        static_cast<const int8_t*>(cache_k) + rows * Hkv * hd,
        static_cast<const int8_t*>(cache_v) + rows * Hkv * hd,
        static_cast<const float*>(k_scale) + rows * Hkv,
        static_cast<const float*>(v_scale) + rows * Hkv,
        static_cast<const int*>(kv_lens), static_cast<ullava::bf16*>(out), H, Hkv, hd, maxS,
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}
