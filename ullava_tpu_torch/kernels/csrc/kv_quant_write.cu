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
// Design: a stream at the memory rate. The k and v heads, taken as one
// list (k's B*S*Hkv heads, then v's), are cut into warp items of NL = 8
// steps; in a step a group of G lanes (G the power of two that holds a
// head's chunks, 16 at hd 128) takes one head, VEC elements a lane (one
// 16-byte load at VEC 8), so a step is 32 / G consecutive heads. A warp
// issues all NL steps' loads before its first reduction (4 KB in flight
// at hd 128), reduces each step's abs-max in bf16 (exact), then all
// steps' shuffles level by level (log2(G) levels), and quantizes and
// stores each step's int8 (8 bytes a lane). The item's scales go through
// shared memory so that lane j stores head j's: consecutive heads of a
// row are consecutive floats of the scale tensor, so they leave as one
// coalesced store an item (64 B at hd 128: half a row of Hkv 32; 16
// steps, a whole row in one 128 B store, ran slower at the serve's shape
// on an H100, with half the blocks an SM). The grid is what the
// SMs hold at once, and each warp walks the items with a stride of the
// grid's warps. Index math is 32-bit (multiply-shift divisions by Hkv and
// S), byte offsets 64-bit. The math is that of quantize_kv_rows: scale =
// max(amax, 1e-12) / 127 as an IEEE division, x / scale rounded as IEEE
// division rounds it (from one reciprocal a head, `div_rn`), round half
// to even, clip to +-127. The destination offset is computed from the
// layer index, the batch row and the cache's own length, so nothing of
// the cache is copied or sliced and rows [S, maxS) and other layers are
// never addressed. hd % 8 != 0 takes an instance of the same template
// with 8-byte loads and two chunks a lane.
#include "common.cuh"

namespace ullava {
namespace kvq {

constexpr int kWarps = 8;  // a block
constexpr int kThreads = kWarps * 32;

// VEC bf16 in one load; VEC int8 in one store.
template <int VEC> struct Raw;
template <> struct Raw<8> { using In = uint4; using Out = uint2; };
template <> struct Raw<4> { using In = uint2; using Out = uint32_t; };

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1).
struct FastDiv {
  int d;
  unsigned mul, shift;
  explicit FastDiv(int divisor) : d(divisor), mul(0), shift(0) {
    if (d != 1) {
      unsigned p = 31;
      while ((1u << (p - 31)) < static_cast<unsigned>(d)) ++p;  // p = 31 + ceil(log2 d)
      mul = static_cast<unsigned>(((1ull << p) + static_cast<unsigned>(d) - 1) / d);
      shift = p - 32;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned>(n), mul) >> shift);
  }
};

struct Args {
  const bf16* src[2];  // k, v: [B, S, Hkv, hd]
  int8_t* cache[2];    // [L, B, maxS, Hkv*hd]
  float* scale[2];     // [L, B, maxS, Hkv]
  int heads;           // B * S * Hkv, a tensor
  int items;           // warp items a tensor
  int hd, Hkv, S, maxS, g_log2;
  FastDiv by_hkv, by_s;
  long long layer_row0;  // layer * B * maxS
};

// The cache row of head n: the layer's row b*maxS + s, and its kv head.
__device__ __forceinline__ long long dst_head(const Args& a, int n) {
  const int r = a.by_hkv.div(n);
  const int h = n - r * a.Hkv;
  const int b = a.by_s.div(r);
  const int s = r - b * a.S;
  return (a.layer_row0 + static_cast<long long>(b) * a.maxS + s) * a.Hkv + h;
}

template <int VEC>
__device__ __forceinline__ float abs_max(const typename Raw<VEC>::In& raw, float m) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  __nv_bfloat162 acc = __habs2(p[0]);
#pragma unroll
  for (int i = 1; i < VEC / 2; ++i) acc = __hmax2(acc, __habs2(p[i]));
  return fmaxf(m, fmaxf(__low2float(acc), __high2float(acc)));
}

// x / scale from r = 1 / scale rounded to nearest (one reciprocal a head):
// q = x r, then one correction by the residual x - q scale taken in an
// fma (Markstein's step). Three full-rate instructions, where the
// compiler's division takes a reciprocal unit issue, a range check and a
// slow-path branch for every element. Over every pair of bf16 x and bf16
// abs-max, |x| <= amax, that the kernel can meet, the int8 code equals
// that of the IEEE quotient, while the quotient's own bits differ on 0.24%
// of the pairs (`ullava_kv_quant_division_check` counts both; on an H100,
// 0 codes and 2,609,895 quotients of 1,065,402,238; the card's tests hold
// the codes).
__device__ __forceinline__ float div_rn(float x, float scale, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, scale, x), r, q);
}

// The int8 code of x: the quotient rounded half to even, clipped to +-127.
__device__ __forceinline__ uint32_t code(float x, float scale, float r) {
  const int q = __float2int_rn(div_rn(x, scale, r));
  return static_cast<uint32_t>(max(-127, min(127, q))) & 0xffu;
}

template <int VEC>
__device__ __forceinline__ typename Raw<VEC>::Out quantize(const typename Raw<VEC>::In& raw,
                                                          float scale, float r) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
  typename Raw<VEC>::Out out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    const uint32_t lo = w[2 * i], hi = w[2 * i + 1];
    o[i] = code(__uint_as_float(lo << 16), scale, r) |
           code(__uint_as_float(lo & 0xffff0000u), scale, r) << 8 |
           code(__uint_as_float(hi << 16), scale, r) << 16 |
           code(__uint_as_float(hi & 0xffff0000u), scale, r) << 24;
  }
  return out;
}

// One warp item: NL steps of 32 / G heads, CPL chunks of VEC a lane and head.
template <int VEC, int CPL, int NL>
__global__ void __launch_bounds__(kThreads) kv_quant_write_kernel(const Args a) {
  __shared__ float item_scales[kWarps][NL * 32];
  using In = typename Raw<VEC>::In;
  using Out = typename Raw<VEC>::Out;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = 1 << a.g_log2;
  const int per_step = 32 >> a.g_log2;  // heads a step
  const int sub = lane >> a.g_log2;      // the lane's head in a step
  const int cl = lane & (G - 1);         // its chunk in the head
  const int per_item = NL * per_step;
  const int chunks = a.hd / VEC;
  const int total = 2 * a.items, stride = gridDim.x * kWarps;
  float* my_scales = item_scales[warp];
  // Selected, not indexed: a parameter array indexed at run time would be
  // copied to local memory.
  auto load = [&](In (&raw)[NL][CPL], int item) {
    const bool t = item >= a.items;
    const int first = (t ? item - a.items : item) * per_item;
    const bf16* src = t ? a.src[1] : a.src[0];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int n = first + i * per_step + sub;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int d = cl + c * G;
        if (n < a.heads && d < chunks) {
          raw[i][c] = *reinterpret_cast<const In*>(src + static_cast<size_t>(n) * a.hd + d * VEC);
        } else {
          raw[i][c] = In{};
        }
      }
    }
  };
  In raw[NL][CPL];
  for (int item = blockIdx.x * kWarps + warp; item < total; item += stride) {
    const bool t = item >= a.items;
    const int first = (t ? item - a.items : item) * per_item;
    int8_t* cache = t ? a.cache[1] : a.cache[0];
    float* scales = t ? a.scale[1] : a.scale[0];
    load(raw, item);
    // Every step's abs-max, then the shuffles level by level, so that the
    // NL reductions overlap instead of running one after another.
    float m[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      m[i] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) m[i] = abs_max<VEC>(raw[i][c], m[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#ifdef ULLAVA_MUTANT_KV_HALF_LANES_AMAX
      if (o < G / 2) {  // each half of the head's lanes keeps its own abs-max
#else
      if (o < G) {
#endif
#pragma unroll
        for (int i = 0; i < NL; ++i) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
      }
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const float scale = fmaxf(m[i], 1e-12f) / 127.0f;
      const float r = __frcp_rn(scale);
      const int n = first + i * per_step + sub;
      if (n < a.heads) {
        int8_t* dst = cache + dst_head(a, n) * a.hd;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int d = cl + c * G;
          if (d < chunks) {
            *reinterpret_cast<Out*>(dst + d * VEC) = quantize<VEC>(raw[i][c], scale, r);
          }
        }
      }
      if (cl == 0) my_scales[i * per_step + sub] = scale;
    }
    __syncwarp();
    for (int j = lane; j < per_item; j += 32) {
      const int n = first + j;
      if (n < a.heads) {
#ifdef ULLAVA_MUTANT_KV_SCALE_ROW_LATE
        scales[dst_head(a, n) + a.Hkv] = my_scales[j];  // one cache row late
#else
        scales[dst_head(a, n)] = my_scales[j];
#endif
      }
    }
    __syncwarp();
  }
}

// The instances: hd % 8 == 0 takes 16-byte loads, a chunk a lane and head
// (hd <= 256); else 8-byte loads, up to two chunks a lane and head.
template <int VEC, int CPL, int NL>
int launch(Args a, cudaStream_t stream) {
  const int chunks = a.hd / VEC;
  const int lanes = (chunks + CPL - 1) / CPL;
  a.g_log2 = 0;
  while ((1 << a.g_log2) < lanes) ++a.g_log2;
  const int per_item = NL * (32 >> a.g_log2);
  a.items = (a.heads + per_item - 1) / per_item;
  static int per_sm = 0;
  if (per_sm <= 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kv_quant_write_kernel<VEC, CPL, NL>, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long need = (2LL * a.items + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
  kv_quant_write_kernel<VEC, CPL, NL>
      <<<static_cast<int>(need < cap ? need : cap), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Every bf16 abs-max amax > 0 (bit patterns 1..0x7f7f) a thread, every
// bf16 x with |x| <= amax, both signs: the codes and the quotients of
// `div_rn` against those of IEEE division (`x / scale`). counts[0] gets
// the pairs whose codes differ, counts[1] those whose quotients' bits do,
// counts[2] the pairs seen.
__global__ void division_check_kernel(unsigned long long* counts) {
  const int a_bits = blockIdx.x * blockDim.x + threadIdx.x + 1;
  if (a_bits > 0x7f7f) return;
  const float amax = __uint_as_float(static_cast<uint32_t>(a_bits) << 16);
  const float scale = fmaxf(amax, 1e-12f) / 127.0f;
  const float r = __frcp_rn(scale);
  unsigned long long codes = 0, quotients = 0, seen = 0;
  for (int x_bits = 0; x_bits <= a_bits; ++x_bits) {
#pragma unroll
    for (int sign = 0; sign < 2; ++sign) {
      const float x = __uint_as_float((static_cast<uint32_t>(x_bits) << 16) |
                                      (static_cast<uint32_t>(sign) << 31));
      const float ieee = x / scale;
      const int q = max(-127, min(127, __float2int_rn(ieee)));
      codes += code(x, scale, r) != (static_cast<uint32_t>(q) & 0xffu);
      quotients += __float_as_uint(div_rn(x, scale, r)) != __float_as_uint(ieee);
      ++seen;
    }
  }
  atomicAdd(&counts[0], codes);
  atomicAdd(&counts[1], quotients);
  atomicAdd(&counts[2], seen);
}

}  // namespace kvq
}  // namespace ullava

// k, v: [B, S, Hkv, hd] bf16; cache_k, cache_v: [L, B, maxS, Hkv*hd] int8;
// k_scale, v_scale: [L, B, maxS, Hkv] f32. hd % 4 == 0, hd <= 256,
// S <= maxS, 0 <= layer < L (checked by the wrapper); B * S * Hkv < 2^31.
ULLAVA_EXPORT int ullava_prefill_quantize_write(const void* k, const void* v,
                                                void* cache_k, void* cache_v,
                                                void* k_scale, void* v_scale,
                                                int B, int S, int Hkv, int hd,
                                                int maxS, int layer, void* stream) {
  using ullava::kvq::Args;
  using ullava::kvq::FastDiv;
  const long long heads = static_cast<long long>(B) * S * Hkv;
  if (heads > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (heads == 0) return static_cast<int>(cudaGetLastError());
  Args a{{static_cast<const ullava::bf16*>(k), static_cast<const ullava::bf16*>(v)},
         {static_cast<int8_t*>(cache_k), static_cast<int8_t*>(cache_v)},
         {static_cast<float*>(k_scale), static_cast<float*>(v_scale)},
         static_cast<int>(heads), 0, hd, Hkv, S, maxS, 0, FastDiv(Hkv), FastDiv(S),
         static_cast<long long>(layer) * B * maxS};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd % 8 == 0 ? ullava::kvq::launch<8, 1, 8>(a, s)
                     : ullava::kvq::launch<4, 2, 8>(a, s);
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the wide
// (hd % 8 == 0) or the narrow instance.
ULLAVA_EXPORT int ullava_prefill_quantize_write_attrs(int narrow, int* out) {
  using namespace ullava::kvq;
  return narrow ? ullava::func_attrs(kv_quant_write_kernel<4, 2, 8>, kThreads, 0, out)
                : ullava::func_attrs(kv_quant_write_kernel<8, 1, 8>, kThreads, 0, out);
}

// The exhaustive check of `div_rn` (`division_check_kernel`) into counts:
// [3] uint64 on the card, zeroed by the caller.
ULLAVA_EXPORT int ullava_kv_quant_division_check(void* counts, void* stream) {
  ullava::kvq::division_check_kernel<<<(0x7f7f + 255) / 256, 256, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
