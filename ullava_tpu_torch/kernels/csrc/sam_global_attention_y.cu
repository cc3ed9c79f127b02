// fused_global_attention_y: SAM ViT global-block attention over the
// 64 x 64 grid (S = 4096, hd 80 for ViT-H, hd 64 for ViT-L and ViT-B) that reads q, k and v in place from the
// raw [B, S, 3C] qkv projection output and writes the head-merged
// [B, S, C] activations, with the decomposed rel-pos bias and an online
// softmax.
//
// Replaces: ullava_tpu/ops/sam_attention.py:652 fused_global_attention_y
// (Pallas, kernel _global_y_kernel :560, pallas_call :734; a program
// handles a slab of heads whose lanes form 128-aligned blocks of y), in
// both of its forms: bf16 scores (`ullava_fused_global_attention_y`) and
// the int8 score form `dots_i8` (the kernel's branch :596-617, here the
// pre-pass `ullava_global_attention_y_quant_i8` and
// `ullava_fused_global_attention_y_i8`).
//
// Bound on the card: at ViT-H B=16 (256 (image, head) pairs) a layer does
// 256 * 4096 * 4096 * 80 * 4 = 1.37e12 FLOP of products, 1.39 ms at the
// bf16 peak, against about 1.2 GB of HBM traffic (0.35 ms): operations.
// The int8 form: 0.35 ms of qk at the int8 peak plus 0.69 ms of bf16 P V;
// its pre-pass moves about 1.1 GB (0.33 ms) and does no products.
//
// Design: the wgmma + TMA global core (global_sm90.cuh) at HD = 80, the
// bias terms pre-scaled by 1/scale in natural column order, [B, S, H, W]
// as the encoder's einsum leaves them, added to q.k before the scale,
// read by TMA over the view {j, h, s, b}. With `exp_bf16` the exponent
// argument and the probabilities are rounded to bf16 as in the TPU
// kernel's serving form.
//
// The hd 64 form (`ullava_fused_global_attention_y_hd64`, bf16 scores):
// ViT-L's and ViT-B's int8-tower global blocks. The TPU kernel reads a
// slab of heads at hd 64 (16 for ViT-L, 4 for ViT-B's 12: two heads a
// 128-lane block of y); here each block reads its head's 64 lanes by TMA
// as one box, so no slab exists and H is any count (the bias view's head
// stride is 128 bytes at every H): the core at HD = 64, 4 k-steps of
// wgmma.m64n128k16. Bound at one ViT-L B=1 block (16 heads): 68.7 GFLOP,
// ~69 us at the bf16 peak; ViT-B's 12 heads 51.5 GFLOP, ~52 us:
// operations.
//
// Its int8 score form at hd 64 (`ullava_global_attention_y_quant_i8_hd64`,
// then `ullava_fused_global_attention_y_i8_hd64`): the pre-pass writes
// [2, B, H, S, 64] code rows in bf16 (exact small integers), which the
// core reads as it reads bf16 q and k (one 128-byte TMA box a row) and
// multiplies on the bf16 tensor cores: the fp32 sums of products of
// integers below 128 over 64 lanes are the int8 product's, exactly. Bound
// at one ViT-L B=1 block: 34 GFLOP of int8 qk (~17 us) and 34 GFLOP of
// bf16 P V (~35 us): operations. Both hd 64 forms run the core's B1
// schedule (global_sm90.cuh). The pre-pass stays a launch of its own: K's
// codes serve all 32 query tiles of a head, so quantizing them in the core
// would repeat it 32 times.
//
// The dots_i8 form quantizes per row once per layer, not once per query
// tile: the pre-pass (one group of 8 threads a row) writes q's and k's
// codes in 128-byte rows (hd 80: int8, zero past it; hd 64: 64 bf16)
// [2, B, H, S, 128 or 64] and their scales [2, B, H, S], and each row's [A | B] codes [B, S, H, 64]
// twice (bf16, exact small integers, in the bias terms' own layout) with
// its scale [B, H, S], in the arithmetic of row_quant (`_rq_rows`): abs-max
// floored at 1e-12, code = rn(x * (127 / amax)) with an IEEE division,
// rounded half to even, scale = amax * (1 / 127). The core then runs qk on
// the int8 tensor cores.
#include "global_sm90.cuh"

namespace ullava {

constexpr int kGlobYHD = 80;

// K11's layout for the global core: q, k, v the head blocks of y, the
// bias terms [B, S, H, 64] as the view {j, h, s, b}.
template <int HD>
struct GlobalY : glob::BiasBSHW {
  static constexpr int kHD = HD;
  static constexpr bool kBiasAfterScale = false;
  static constexpr bool kBiasRaw = false;
  static constexpr int kQkvHeads = 3;
  __device__ static int k_head(int h, int H) { return H + h; }
  __device__ static int v_head(int h, int H) { return 2 * H + h; }
};

// The dots_i8 pre-pass. Group gid (8 threads) of B * S * H * 3 takes row
// kind = gid % 3 (q, k, or [A | B]) of (b, s, h) = gid / 3. For q and k
// thread t < HD / 16 owns elements 16 t .. 16 t + 15 of the HD and writes
// their codes as one 16-byte store; the other threads write the zero pad
// of the 128-byte row. At hd 64 the codes are bf16 (exact small integers,
// 64 a 128-byte row, two 16-byte stores a thread). For [A | B] threads
// 0-3 own A's 64 terms and 4-7 B's, 16 each.
template <int HD>
__global__ void __launch_bounds__(256) global_y_quant_i8_kernel(
    const bf16* __restrict__ y, const bf16* __restrict__ a, const bf16* __restrict__ bb,
    void* __restrict__ codes, float* __restrict__ scales, bf16* __restrict__ ac,
    bf16* __restrict__ bc, float* __restrict__ abss, int B, int H) {
  constexpr int S = glob::kS, W = glob::kW;
  constexpr bool kCodes16 = HD == 64;  // bf16 codes (the core's B1 form)
  static_assert(HD % 16 == 0 && HD <= 128 && (!kCodes16 || 2 * HD == 128),
                "whole 16-byte code chunks in a 128-byte row");
  const long gid = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) / 8;
  const int t = threadIdx.x % 8;
  const long rows = static_cast<long>(B) * S * H;
  const bool live = gid < rows * 3;  // the last block's tail groups only shuffle
  const int kind = live ? static_cast<int>(gid % 3) : 0;
  const long bsh = live ? gid / 3 : 0;  // (b * S + s) * H + h
  const int h = static_cast<int>(bsh % H);
  const long bs = bsh / H;
  const int b = static_cast<int>(bs / S), s = static_cast<int>(bs % S);

  float x[16];
  const bf16* src = nullptr;
  if (kind < 2) {
    if (t < HD / 16) src = y + (bs * 3 + kind) * (H * HD) + h * HD + 16 * t;
  } else {
    src = (t < 4 ? a : bb) + bsh * W + 16 * (t % 4);
  }
  float amax = 0.f;
  if (src != nullptr) {
    const uint4 raw[2] = {reinterpret_cast<const uint4*>(src)[0],
                          reinterpret_cast<const uint4*>(src)[1]};
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 f = __bfloat1622float2(v[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = 0.f;
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (!live) return;
  amax = fmaxf(amax, 1e-12f);
  const float inv = __fdiv_rn(127.f, amax);
  const float scale = __fmul_rn(amax, 1.f / 127.f);
  const size_t row = (static_cast<size_t>(b) * H + h) * S + s;  // (b, h, s)
  if (kind < 2) {
    const size_t at = static_cast<size_t>(kind) * B * H * S + row;
    if constexpr (kCodes16) {
      if (t < HD / 16) {
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = sm90::pack_bf16(static_cast<float>(__float2int_rn(__fmul_rn(x[2 * i], inv))),
                                 static_cast<float>(__float2int_rn(__fmul_rn(x[2 * i + 1], inv))));
        uint4* dst = reinterpret_cast<uint4*>(static_cast<char*>(codes) + at * 128 + 32 * t);
        dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
        dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    } else {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = 0u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = __float2int_rn(__fmul_rn(x[4 * i + k], inv));
          w[i] |= (static_cast<uint32_t>(q) & 0xffu) << (8 * k);
        }
      }
      *reinterpret_cast<uint4*>(static_cast<char*>(codes) + at * 128 + 16 * t) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (t == 0) scales[at] = scale;
  } else {
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = sm90::pack_bf16(static_cast<float>(__float2int_rn(__fmul_rn(x[2 * i], inv))),
                             static_cast<float>(__float2int_rn(__fmul_rn(x[2 * i + 1], inv))));
    uint4* dst = reinterpret_cast<uint4*>((t < 4 ? ac : bc) + bsh * W + 16 * (t % 4));
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    if (t == 0) abss[row] = scale;
  }
}

template <int HD, bool DOTS>
int launch_global_y(const void* y, const void* a, const void* b, const void* codes,
                    const void* scales, const void* abss, void* o, int B, int H, float scale,
                    int exp_bf16, void* stream) {
  const glob::Params p{static_cast<bf16*>(o), static_cast<const float*>(scales),
                       static_cast<const float*>(abss), B, H,
                       exp_bf16 ? scale : scale * glob::kLog2e, 1.f / scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return exp_bf16
             ? glob::launch_global<GlobalY<HD>, true, DOTS>(y, y, y, a, b, codes, scales, p, st)
             : glob::launch_global<GlobalY<HD>, false, DOTS>(y, y, y, a, b, codes, scales, p, st);
}

// The dots_i8 pre-pass at hd HD (`codes` zero past it).
template <int HD>
int launch_quant_i8(const void* y, const void* a, const void* b, void* codes, void* scales,
                    void* ac, void* bc, void* abss, int B, int H, void* stream) {
  const long groups = 3l * B * glob::kS * H;
  if (groups == 0) return 0;
  const int blocks = static_cast<int>((groups * 8 + 255) / 256);
  global_y_quant_i8_kernel<HD><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      codes, static_cast<float*>(scales), static_cast<bf16*>(ac),
      static_cast<bf16*>(bc), static_cast<float*>(abss), B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ullava

// y [B, 4096, 3 * H * 80], a, b [B, 4096, H, 64], o [B, 4096, H * 80], bf16.
ULLAVA_EXPORT int ullava_fused_global_attention_y(const void* y, const void* a, const void* b,
                                                  void* o, int B, int H, float scale,
                                                  int exp_bf16, void* stream) {
  return ullava::launch_global_y<ullava::kGlobYHD, false>(y, a, b, nullptr, nullptr, nullptr, o,
                                                          B, H, scale, exp_bf16, stream);
}

// The hd 64 form (ViT-L, ViT-B), bf16 scores: y [B, 4096, 3 * H * 64], a, b
// [B, 4096, H, 64], o [B, 4096, H * 64], bf16.
ULLAVA_EXPORT int ullava_fused_global_attention_y_hd64(const void* y, const void* a,
                                                       const void* b, void* o, int B, int H,
                                                       float scale, int exp_bf16, void* stream) {
  return ullava::launch_global_y<64, false>(y, a, b, nullptr, nullptr, nullptr, o, B, H, scale,
                                            exp_bf16, stream);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the hd 64 form's kernel (`exp_bf16` 0 or 1).
ULLAVA_EXPORT int ullava_fused_global_attention_y_hd64_attrs(int exp_bf16, int* out) {
  using namespace ullava;
  return exp_bf16 ? glob::attrs<GlobalY<64>, true, false>(out)
                  : glob::attrs<GlobalY<64>, false, false>(out);
}

// The dots_i8 pre-pass. y, a, b as above; codes [2, B, H, 4096, 128] int8
// (q's then k's), scales [2, B, H, 4096] fp32, ac, bc [B, 4096, H, 64]
// bf16 (the codes of each row's [A | B]), abss [B, H, 4096] fp32.
ULLAVA_EXPORT int ullava_global_attention_y_quant_i8(const void* y, const void* a,
                                                     const void* b, void* codes, void* scales,
                                                     void* ac, void* bc, void* abss, int B,
                                                     int H, void* stream) {
  return ullava::launch_quant_i8<ullava::kGlobYHD>(y, a, b, codes, scales, ac, bc, abss, B, H,
                                                   stream);
}

// The dots_i8 form on the pre-pass's outputs: int8 scores (q, k and the
// bias terms' codes), bf16 P V read from y, either exponential form.
ULLAVA_EXPORT int ullava_fused_global_attention_y_i8(const void* y, const void* codes,
                                                     const void* scales, const void* ac,
                                                     const void* bc, const void* abss, void* o,
                                                     int B, int H, float scale, int exp_bf16,
                                                     void* stream) {
  return ullava::launch_global_y<ullava::kGlobYHD, true>(y, ac, bc, codes, scales, abss, o, B,
                                                         H, scale, exp_bf16, stream);
}

// The hd 64 pre-pass (ViT-L, ViT-B): y [B, 4096, 3 * H * 64]; the outputs
// as the hd 80 pre-pass's but the codes, [2, B, H, 4096, 64] bf16.
ULLAVA_EXPORT int ullava_global_attention_y_quant_i8_hd64(const void* y, const void* a,
                                                          const void* b, void* codes,
                                                          void* scales, void* ac, void* bc,
                                                          void* abss, int B, int H,
                                                          void* stream) {
  return ullava::launch_quant_i8<64>(y, a, b, codes, scales, ac, bc, abss, B, H, stream);
}

// The hd 64 dots_i8 form on the hd 64 pre-pass's outputs; o [B, 4096, H * 64].
ULLAVA_EXPORT int ullava_fused_global_attention_y_i8_hd64(const void* y, const void* codes,
                                                          const void* scales, const void* ac,
                                                          const void* bc, const void* abss,
                                                          void* o, int B, int H, float scale,
                                                          int exp_bf16, void* stream) {
  return ullava::launch_global_y<64, true>(y, ac, bc, codes, scales, abss, o, B, H, scale,
                                           exp_bf16, stream);
}

// {registers a thread, shared bytes a block, spilled bytes a thread,
// blocks an SM} of the hd 64 dots_i8 form's kernel (`exp_bf16` 0 or 1).
ULLAVA_EXPORT int ullava_fused_global_attention_y_i8_hd64_attrs(int exp_bf16, int* out) {
  using namespace ullava;
  return exp_bf16 ? glob::attrs<GlobalY<64>, true, true>(out)
                  : glob::attrs<GlobalY<64>, false, true>(out);
}
