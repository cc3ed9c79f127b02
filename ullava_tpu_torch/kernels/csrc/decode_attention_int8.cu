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
// Design of K8:
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
//                                          left out.
//
// decode_attention_int8 (second entry, K22) is K8's read side without the
// write, in the arithmetic of its own TPU kernel, which differs from K8's:
// the mask is pos < kv_lens[b] (:121; a row with kv_lens <= 0 gives every
// position the same masked score, so a uniform average over all maxS
// positions, as there); the scale folds into the fp32 key-scale multiply
// (:113-120); P is normalized before the product with the value scale is
// rounded to bf16, pv = bf16((e / l) * v_scale) (:122-125), and the output
// is the fp32 sum of pv * Vq rounded to bf16, with no division after it.
// Its bound is K8's: bytes, the kv_lens[b] rows of K and V a sample and
// their scales (all maxS V rows for a uniform row).
//
// Design of K22: that rounding point needs the final max and sum before
// the first value row is weighed, so K8's one online pass cannot be used
// as it stands; a block makes two passes over its rows with K8's loads.
// Pass 1 streams the K rows in warp tiles (kLoads 16-byte row loads a lane
// issued before any is consumed, the row's k and v scales in the same
// batch, codes by codes16), parks each row's fp32 score beside its v scale
// in shared memory and keeps a running max and sum; the row groups and
// warps merge their (m, l) behind one block barrier. Pass 2 streams the V
// rows the same way and weighs each by its parked score with the final m
// and l. Where B x H blocks are too few to fill the card, the wrapper
// splits a sample's rows over `splits` <= 8 blocks that form one thread
// block cluster (the portable size): each publishes its (m, l) in its own
// shared memory; after a cluster barrier every block reads its peers'
// through distributed shared memory and forms the global m and l; its
// pass 2 then gives an o that needs no rescaling, and after a second
// barrier the leader block sums the peers' o's the same way and writes
// out (a third keeps the peers' shared memory alive until it has). No
// counters, atomics or spin-waits; the cluster runs its blocks together.
// Shared memory holds 8 bytes a row of a block: the rows a cache can have
// are what a block parks times `splits`.
//
// Deliberate bugs of K22's gates, each built only into a copy:
//   ULLAVA_MUTANT_DECODE_NO_KV_LENS        all maxS rows attended;
//   ULLAVA_MUTANT_DECODE_PEER_L_DROPPED    the last peer's l left out of
//                                          the cluster's global sum.
#include <cooperative_groups.h>

#include "common.cuh"

namespace ullava {

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

// This lane's 16 dims of q head h of sample b as floats.
__device__ __forceinline__ void q16(const bf16* q, int b, int H, int h, int hd, int chunk,
                                    float (&qf)[16]) {
  const bf16* qp = q + (static_cast<long long>(b) * H + h) * hd + chunk * 16;
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qp + i));
    qf[i] = t.x;
    qf[i + 1] = t.y;
  }
}

// q . Kq of a cache row whose 16-byte chunks the lpp lanes of a group hold,
// returned to each of them.
__device__ __forceinline__ float row_dot(const int4& raw, const float (&qf)[16], int lpp) {
  float f[16];
  codes16(raw, f);
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) d += f[i] * qf[i];
  for (int off = lpp >> 1; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  return d;
}

// [lo, hi): split `split`'s rows of a sample's n, whole warp tiles of
// `tile` rows.
__device__ __forceinline__ void split_rows(int n, int splits, int split, int tile, int& lo,
                                           int& hi) {
  const int per = ((n + splits - 1) / splits + tile - 1) / tile * tile;
  lo = min(split * per, n);
  hi = min(lo + per, n);
}

// (m, l) of another softmax state folded into this one at the larger max.
__device__ __forceinline__ void fold_ml(float& m, float& l, float m2, float l2) {
  const float mx = fmaxf(m, m2);
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
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
  int lo, hi;  // this block's rows
  split_rows(n, splits, split, tile, lo, hi);

  const long long row0 = static_cast<long long>(b) * maxS;
  const long long head_off = static_cast<long long>(kvh) * hd + chunk * 16;
  const long long new_off = static_cast<long long>(b) * Ckv + head_off;
  const long long sc_new = static_cast<long long>(b) * Hkv + kvh;

  float qf[16];
  q16(q, b, H, h, hd, chunk, qf);

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
      s[u] = row_dot(kr[u], qf, lpp) * (ks[u] * scale);
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

// Masked score of the TPU kernel (-0.7 * the largest fp32).
constexpr float kMasked = -0.7f * 3.4028234663852886e38f;
constexpr int kMaxSplits = 8;                 // a portable cluster
constexpr int kReadSmemMax = 200 * 1024;      // parked rows a block, in bytes

// K22 (see the header): grid (splits, H, B); with splits > 1 the splits of
// a (b, h) are one cluster. s_sv holds this block's (score, v scale) rows.
__global__ void __launch_bounds__(kThreads, 4)
read_kernel(
    const bf16* __restrict__ q,            // [B, H, hd]
    const int8_t* __restrict__ cache_k,    // this layer: [B, maxS, Hkv*hd]
    const int8_t* __restrict__ cache_v,
    const float* __restrict__ k_scale,     // this layer: [B, maxS, Hkv]
    const float* __restrict__ v_scale,
    const int* __restrict__ kv_lens,       // [B]
    bf16* __restrict__ out,                // [B, H, hd]
    int H, int Hkv, int hd, int maxS, float scale) {
  namespace cg = cooperative_groups;
  extern __shared__ float2 s_sv[];
  __shared__ float s_o[kWarps * kMaxHd];
  __shared__ float s_part[kMaxHd];  // this block's o, read by the leader
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float2 s_ml;  // this block's (m, l), read by its peers

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int kvh = h / (H / Hkv);
  const int Ckv = Hkv * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lpp = hd / 16, rpl = 32 / lpp;
  const int sub = lane / lpp, chunk = lane % lpp;
  const int tile = rpl * kLoads;

#ifdef ULLAVA_MUTANT_DECODE_NO_KV_LENS
  const int kvl = maxS;
#else
  const int kvl = kv_lens[b];
#endif
  const bool none = kvl <= 0;  // every position masked: a uniform average
  const int n = none ? maxS : min(kvl, maxS);  // positions past n have p = 0
  int lo, hi;
  split_rows(n, splits, split, tile, lo, hi);

  const long long row0 = static_cast<long long>(b) * maxS;
  const long long head_off = static_cast<long long>(kvh) * hd + chunk * 16;
  float qf[16];
  q16(q, b, H, h, hd, chunk, qf);

  // Pass 1: s = (q . Kq) * (k_scale * scale), parked with the v scale;
  // the running max and sum of this lane's row group.
  float m = kNone, l = 0.f;
  for (int t0 = lo + warp * tile; t0 < hi; t0 += kWarps * tile) {
    int4 kr[kLoads];
    float ks[kLoads], vs[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = t0 + u * rpl + sub;
      kr[u] = make_int4(0, 0, 0, 0);
      ks[u] = vs[u] = 0.f;
      if (p < hi) {
        const long long r = row0 + p;
        if (!none) {
          kr[u] = *reinterpret_cast<const int4*>(cache_k + r * Ckv + head_off);
          ks[u] = k_scale[r * Hkv + kvh];
        }
        vs[u] = v_scale[r * Hkv + kvh];
      }
    }
    float s[kLoads], mt = kNone;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = t0 + u * rpl + sub;
      s[u] = none ? kMasked : row_dot(kr[u], qf, lpp) * (ks[u] * scale);
      if (p < hi) {
        mt = fmaxf(mt, s[u]);
        if (chunk == 0) s_sv[p - lo] = make_float2(s[u], vs[u]);
      }
    }
    const float mn = fmaxf(m, mt);
    l *= expf(m - mn);
    m = mn;
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (t0 + u * rpl + sub < hi) l += expf(s[u] - m);
  }

  // The block's (m, l): the warp's row groups, then the warps (every
  // thread merges the four in the same order).
  for (int off = lpp; off < 32; off <<= 1)
    fold_ml(m, l, __shfl_xor_sync(0xffffffffu, m, off), __shfl_xor_sync(0xffffffffu, l, off));
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();  // also: every parked row is in place
  m = s_m[0];
  l = s_l[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) fold_ml(m, l, s_m[w], s_l[w]);

  cg::cluster_group cluster = cg::this_cluster();
  if (splits > 1) {  // the cluster's (m, l): lane r reads block r's
    if (tid == 0) s_ml = make_float2(m, l);
    cluster.sync();
    float pm = kNone, pl = 0.f;
    if (lane < splits) {
      const float2 v = *cluster.map_shared_rank(&s_ml, lane);
      pm = v.x;
#ifdef ULLAVA_MUTANT_DECODE_PEER_L_DROPPED
      pl = lane == splits - 1 ? 0.f : v.y;
#else
      pl = v.y;
#endif
    }
    for (int off = 1; off < 32; off <<= 1)
      fold_ml(pm, pl, __shfl_xor_sync(0xffffffffu, pm, off),
              __shfl_xor_sync(0xffffffffu, pl, off));
    m = __shfl_sync(0xffffffffu, pm, 0);  // one order for every block
    l = __shfl_sync(0xffffffffu, pl, 0);
  }

  // Pass 2: o[d] = sum pv * Vq[., d], pv = bf16((exp(s - m) / l) * v_scale).
  float o[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = 0.f;
  for (int t0 = lo + warp * tile; t0 < hi; t0 += kWarps * tile) {
    int4 vr[kLoads];
    float2 sv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int p = t0 + u * rpl + sub;
      vr[u] = make_int4(0, 0, 0, 0);
      sv[u] = make_float2(0.f, 0.f);
      if (p < hi) {
        vr[u] = *reinterpret_cast<const int4*>(cache_v + (row0 + p) * Ckv + head_off);
        sv[u] = s_sv[p - lo];
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (t0 + u * rpl + sub >= hi) continue;
      const float pv = __bfloat162float(__float2bfloat16_rn((expf(sv[u].x - m) / l) * sv[u].y));
      float f[16];
      codes16(vr[u], f);
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] += pv * f[i];
    }
  }
  for (int off = lpp; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] += __shfl_xor_sync(0xffffffffu, o[i], off);
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < 16; ++i) s_o[warp * hd + chunk * 16 + i] = o[i];
  }
  __syncthreads();
  bf16* dst = out + (static_cast<long long>(b) * H + h) * hd;
  for (int d = tid; d < hd; d += kThreads) {
    float od = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) od += s_o[w * hd + d];
    if (splits == 1)
      dst[d] = __float2bfloat16_rn(od);
    else
      s_part[d] = od;
  }
  if (splits > 1) {
    cluster.sync();  // every block's o is in place
    if (cluster.block_rank() == 0) {
      for (int d = tid; d < hd; d += kThreads) {
        float od = 0.f;
        for (int r = 0; r < splits; ++r) od += *cluster.map_shared_rank(s_part + d, r);
        dst[d] = __float2bfloat16_rn(od);
      }
    }
    cluster.sync();  // the peers' shared memory outlives the leader's reads
  }
}

// Parked rows a block of K22 needs for a cache of maxS rows over `splits`.
inline int read_rows(int maxS, int hd, int splits) {
  const int tile = 32 / (hd / 16) * kLoads;
  return ((maxS + splits - 1) / splits + tile - 1) / tile * tile;
}

inline int read_configure() {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kReadSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

}  // namespace dec
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
// 2^n <= 512, H % Hkv == 0, 0 <= layer < L (checked by the wrapper);
// 1 <= splits <= 8 blocks a (b, h), one cluster where splits > 1, and
// read_rows(maxS, hd, splits) * 8 bytes <= 200 KB (checked here too).
ULLAVA_EXPORT int ullava_decode_attention_int8(const void* q, const void* cache_k,
                                               const void* cache_v, const void* k_scale,
                                               const void* v_scale, const void* kv_lens,
                                               void* out, int B, int H, int Hkv, int hd,
                                               int maxS, int layer, float scale, int splits,
                                               void* stream) {
  using namespace ullava::dec;
  if (splits < 1 || splits > kMaxSplits) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(read_rows(maxS, hd, splits)) * sizeof(float2);
  if (smem > static_cast<size_t>(kReadSmemMax)) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = read_configure()) return err;
  if (B <= 0) return 0;
  const long long rows = static_cast<long long>(layer) * B * maxS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, read_kernel, static_cast<const ullava::bf16*>(q),
      static_cast<const int8_t*>(cache_k) + rows * Hkv * hd,
      static_cast<const int8_t*>(cache_v) + rows * Hkv * hd,
      static_cast<const float*>(k_scale) + rows * Hkv,
      static_cast<const float*>(v_scale) + rows * Hkv, static_cast<const int*>(kv_lens),
      static_cast<ullava::bf16*>(out), H, Hkv, hd, maxS, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// {registers, shared bytes, spilled bytes, blocks an SM} of K22's kernel
// with `rows` parked rows a block.
ULLAVA_EXPORT int ullava_decode_attention_int8_attrs(int rows, int* out) {
  using namespace ullava::dec;
  if (const int err = read_configure()) return err;
  return ullava::func_attrs(read_kernel, kThreads, static_cast<size_t>(rows) * sizeof(float2),
                            out);
}
