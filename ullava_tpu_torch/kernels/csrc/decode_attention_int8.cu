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
// Design (the old three-pass form lives on in K22's read kernel, below):
// one block of 4 warps per (q head, sample, split); the kv head is
// h / (H / Hkv), so GQA needs no expansion. hd/16 lanes share a cache row
// (16 int8 = one 16-byte load a lane), so a warp covers 32 / (hd/16) rows
// a load, and takes a tile of kLoads such loads: every lane issues its
// kLoads K rows, kLoads V rows and their scales before it consumes any,
// 8 x 16 bytes in flight a lane (one before), and K and V of a row come
// in together. Each group of lanes that shares a row keeps an online
// softmax in fp32 over the rows it sees (running max m, denominator l,
// o[d] = sum e * v_scale * Vq[., d], rescaled by exp(m_old - m_new)), so
// no pass waits on a block barrier; the groups and warps merge their
// (m, l, o) at the end. A head's scales lie Hkv floats apart in the
// [B, maxS, Hkv] layout, so they cannot come as one vector over rows: the
// lanes of a row read its two scales in the load batch of the tile (one
// request a row and warp), not after the dot. int8 codes become floats
// exactly by the 2^23 trick (byte ^ 0x80 as a mantissa, minus 2^23 + 128)
// instead of a conversion instruction. The arithmetic is the old kernel's
// in fp32: s = (q . Kq) * (k_scale * scale), e = exp(s - m),
// o += (e * v_scale) * Vq, out = o / l rounded to bf16; only the order of
// the sums (and the rescaling) differs. At B=16 the card holds all 512
// blocks at once (111 registers a thread, four blocks an SM), about 8 MB
// in flight; on an H100, two tiles a warp in registers, 8 loads a lane, or
// a cp.async ring of three tiles a warp in shared memory ran no faster.
//
// Where B x H blocks are too few to fill the card, the wrapper splits a
// sample's rows over `splits` blocks, each a range of whole warp tiles;
// each writes its (m, l, o) to a scratch row, and the last of the (b, h)
// blocks to arrive at its counter (an atomic add after a fence; the
// wrapper zeroes the counters for each call) merges them in fp32, rescaled
// to the common max, and writes out: one launch. "Position" write_pos[b] is the current token:
// its data comes from the quantized new row instead of the cache, so the
// cache rows at and after write_pos[b] are never read (the staleness
// mask) and the current token is scored with the same arithmetic as a
// cached one. The first split's block of a kv head's first q head then
// stores the new K/V row and its two scales at write_pos[b]. Other blocks
// of this launch read rows below write_pos[b] only, so the store races
// with nothing. write_pos is read from device memory; a position outside
// [0, maxS) attends over the clamped range and stores nothing.
//
// Deliberate bugs for the correctness gate (chip_smoke.py), each built
// only into a copy of this source under its define:
//   ULLAVA_MUTANT_DECODE_MERGE_NO_RESCALE  the splits' partials summed
//                                          without rescaling to the
//                                          common max;
//   ULLAVA_MUTANT_DECODE_SPLIT_LAST_TILE   the last warp tile of a split
//                                          left out;
//   ULLAVA_MUTANT_DECODE_NO_KV_LENS        (K22) all maxS rows attended.
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

namespace dec {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;     // row loads a lane issues before it consumes, per operand
constexpr int kMaxHd = 512;
constexpr float kNone = -3.0e38f;  // the running max before any row

// The 16 int8 codes of a 16-byte load as exact floats: byte ^ 0x80 is the
// code + 128 in [0, 255], put in the low mantissa byte of 2^23.
__device__ __forceinline__ void codes16(const int4& raw, float (&f)[16]) {
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x), static_cast<uint32_t>(raw.y),
                         static_cast<uint32_t>(raw.z), static_cast<uint32_t>(raw.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    f[4 * i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
    f[4 * i + 1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
    f[4 * i + 2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
    f[4 * i + 3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
  }
}

// (m, l, o) of another state folded into this one, both rescaled to the
// larger max.
__device__ __forceinline__ void fold(float& m, float& l, float (&o)[16], float m2, float l2,
                                     const float (&o2)[16]) {
  const float mx = fmaxf(m, m2);
  const float a = expf(m - mx), c = expf(m2 - mx);
  l = l * a + l2 * c;
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = o[i] * a + o2[i] * c;
  m = mx;
}

__global__ void __launch_bounds__(kThreads, 4)
fused_write_kernel(
    const bf16* __restrict__ q,          // [B, H, hd]
    const int8_t* __restrict__ kq_new,   // [B, Hkv*hd]
    const float* __restrict__ ks_new,    // [B, Hkv]
    const int8_t* __restrict__ vq_new,   // [B, Hkv*hd]
    const float* __restrict__ vs_new,    // [B, Hkv]
    int8_t* cache_k, int8_t* cache_v,    // this layer: [B, maxS, Hkv*hd]
    float* k_scale, float* v_scale,      // this layer: [B, maxS, Hkv]
    const int* __restrict__ write_pos,   // [B]
    bf16* __restrict__ out,              // [B, H, hd]
    float* part,                         // [B, H, splits, 2 + hd] where splits > 1
    int* counter,                        // [B, H], zero, where splits > 1
    int H, int Hkv, int hd, int maxS, float scale, int splits) {
  __shared__ float s_o[kWarps * kMaxHd];
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ int s_last;

  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int rep = H / Hkv;
  const int kvh = h / rep;
  const int Ckv = Hkv * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpp = hd / 16;       // lanes per row
  const int rpl = 32 / lpp;      // rows a warp load covers
  const int sub = lane / lpp;    // which of them
  const int chunk = lane % lpp;  // which 16 dims of the head
  const int tile = rpl * kLoads; // rows of a warp tile

  const int wp_raw = write_pos[b];
  const int wp = min(max(wp_raw, 0), maxS);  // rows [0, wp) are history
  const int n = wp + 1;                      // plus the current token
  // This block's rows, [lo, hi): whole warp tiles of the sample's n.
  const int per = ((n + splits - 1) / splits + tile - 1) / tile * tile;
  const int lo = min(split * per, n), hi = min(lo + per, n);

  const long long row0 = static_cast<long long>(b) * maxS;
  const long long head_off = static_cast<long long>(kvh) * hd + chunk * 16;
  const long long new_off = static_cast<long long>(b) * Ckv + head_off;
  const long long sc_new = static_cast<long long>(b) * Hkv + kvh;

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

  float m = kNone, l = 0.f, o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;

  for (int t0 = lo + warp * tile; t0 < hi; t0 += kWarps * tile) {
#ifdef ULLAVA_MUTANT_DECODE_SPLIT_LAST_TILE
    if (t0 + tile >= hi) break;
#endif
    // Every load of the tile first: kLoads K rows, kLoads V rows, scales.
    int4 kr[kLoads], vr[kLoads];
    float ks[kLoads], vs[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = t0 + u * rpl + sub;
      kr[u] = vr[u] = make_int4(0, 0, 0, 0);
      ks[u] = vs[u] = 0.f;
      if (p < hi) {
        const bool hist = p < wp;
        const long long at = (row0 + p) * Ckv + head_off;
        kr[u] = *reinterpret_cast<const int4*>(hist ? cache_k + at : kq_new + new_off);
        vr[u] = *reinterpret_cast<const int4*>(hist ? cache_v + at : vq_new + new_off);
        const long long sat = (row0 + p) * Hkv + kvh;
        ks[u] = hist ? k_scale[sat] : ks_new[sc_new];
        vs[u] = hist ? v_scale[sat] : vs_new[sc_new];
      }
    }
    // Scores of the tile's rows, summed over the lanes that share a row.
    float s[kLoads], mt = kNone;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      float f[16];
      codes16(kr[u], f);
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) d += f[i] * qf[i];
      for (int off = lpp >> 1; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
      s[u] = d * (ks[u] * scale);
      if (t0 + u * rpl + sub < hi) mt = fmaxf(mt, s[u]);
    }
    // The online softmax step: rescale to the new max, add the tile.
    const float mn = fmaxf(m, mt);
    const float corr = expf(m - mn);
    l *= corr;
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] *= corr;
    m = mn;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (t0 + u * rpl + sub >= hi) continue;
      const float e = expf(s[u] - m);
      l += e;
      const float pv = e * vs[u];
      float f[16];
      codes16(vr[u], f);
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] += pv * f[i];
    }
  }

  // Merge the warp's row groups, then the warps.
  for (int off = lpp; off < 32; off <<= 1) {
    float o2[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o2[i] = __shfl_xor_sync(0xffffffffu, o[i], off);
    fold(m, l, o, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, l, off), o2);
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) s_o[warp * hd + chunk * 16 + i] = o[i];
    if (chunk == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
  }
  __syncthreads();
  float bm = s_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) bm = fmaxf(bm, s_m[w]);
  float bl = 0.f, f[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    f[w] = expf(s_m[w] - bm);
    bl += s_l[w] * f[w];
  }
  const long long bh = static_cast<long long>(b) * H + h;
  if (splits == 1) {
    for (int d = tid; d < hd; d += kThreads) {
      float od = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) od += s_o[w * hd + d] * f[w];
      out[bh * hd + d] = __float2bfloat16_rn(od / bl);
    }
  } else {
    float* mine = part + (bh * splits + split) * (2 + hd);
    for (int d = tid; d < hd; d += kThreads) {
      float od = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) od += s_o[w * hd + d] * f[w];
      mine[2 + d] = od;
    }
    if (tid == 0) {
      mine[0] = bm;
      mine[1] = bl;
    }
    __threadfence();  // the partial is visible before the count says so
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(counter + bh, 1) == splits - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      const float* all = part + bh * splits * (2 + hd);
      float gm = kNone;
      for (int j = 0; j < splits; ++j) gm = fmaxf(gm, __ldcg(all + j * (2 + hd)));
      for (int d = tid; d < hd; d += kThreads) {
        float gl = 0.f, od = 0.f;
        for (int j = 0; j < splits; ++j) {
          const float* pj = all + j * (2 + hd);
#ifdef ULLAVA_MUTANT_DECODE_MERGE_NO_RESCALE
          const float c = 1.f;
#else
          const float c = expf(__ldcg(pj) - gm);
#endif
          gl += __ldcg(pj + 1) * c;
          od += __ldcg(pj + 2 + d) * c;
        }
        out[bh * hd + d] = __float2bfloat16_rn(od / gl);
      }
    }
  }

  // The new row, once per kv head.
  if (h % rep == 0 && split == 0 && wp_raw >= 0 && wp_raw < maxS) {
    const long long dst_row = row0 + wp_raw;
    for (int c = tid; c < 2 * lpp; c += kThreads) {
      const bool is_v = c >= lpp;
      const long long off = static_cast<long long>(kvh) * hd + (c % lpp) * 16;
      const int8_t* src = (is_v ? vq_new : kq_new) + static_cast<long long>(b) * Ckv + off;
      int8_t* dst = (is_v ? cache_v : cache_k) + dst_row * Ckv + off;
      *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
    }
    if (tid == 0) {
      k_scale[dst_row * Hkv + kvh] = ks_new[sc_new];
      v_scale[dst_row * Hkv + kvh] = vs_new[sc_new];
    }
  }
}

}  // namespace dec

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
// k_scale, v_scale: [L, B, maxS, Hkv] f32; write_pos: [B] int32. Where
// splits > 1: part [B, H, splits, 2 + hd] f32 scratch and counter [B, H]
// int32, zero; both unused otherwise.
// hd = 16 * 2^n <= 512, H % Hkv == 0, 0 <= layer < L, 1 <= splits
// (checked by the wrapper).
ULLAVA_EXPORT int ullava_decode_attention_int8_fused_write(
    const void* q, const void* kq_new, const void* ks_new, const void* vq_new,
    const void* vs_new, void* cache_k, void* cache_v, void* k_scale, void* v_scale,
    const void* write_pos, void* out, void* part, void* counter, int B, int H, int Hkv, int hd,
    int maxS, int layer, float scale, int splits, void* stream) {
  if (B > 0) {
    const long long rows = static_cast<long long>(layer) * B * maxS;
    const dim3 grid(H, B, splits);
    ullava::dec::fused_write_kernel<<<grid, ullava::dec::kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const ullava::bf16*>(q), static_cast<const int8_t*>(kq_new),
        static_cast<const float*>(ks_new), static_cast<const int8_t*>(vq_new),
        static_cast<const float*>(vs_new),
        static_cast<int8_t*>(cache_k) + rows * Hkv * hd,
        static_cast<int8_t*>(cache_v) + rows * Hkv * hd,
        static_cast<float*>(k_scale) + rows * Hkv,
        static_cast<float*>(v_scale) + rows * Hkv,
        static_cast<const int*>(write_pos), static_cast<ullava::bf16*>(out),
        static_cast<float*>(part), static_cast<int*>(counter), H, Hkv, hd, maxS, scale, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the
// write-and-attend kernel (`form` unused).
ULLAVA_EXPORT int ullava_decode_attention_int8_fused_write_attrs(int, int* out) {
  return ullava::func_attrs(ullava::dec::fused_write_kernel, ullava::dec::kThreads, 0, out);
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
