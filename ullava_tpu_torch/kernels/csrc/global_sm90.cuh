// The SAM global-block attention core for Hopper (sm_90a) on wgmma and
// TMA: attention of each (image, head) over all S = 4096 tokens of the
// 64 x 64 grid with the decomposed rel-pos bias, online softmax, acc / l
// at the end. Three kernels run on it:
//   - K11 fused_global_attention_y (sam_global_attention_y.cu): hd 80
//     (ViT-H; and hd 64, ViT-L's and ViT-B's head), q/k/v read in
//     place from the LN+qkv output [B, S, 3 * H * 80], the
//     bias terms pre-scaled by 1/scale, [B, S, H, 64], added before the
//     scale; bf16 or int8 scores (DOTS_I8), fp32 or bf16 exponentials;
//   - K20 fused_global_attention_packed (sam_packed_attention.cu): the HD
//     real lanes (64 or 80) of the 128-lane blocks (part * H + h) * 128 of
//     [B, S, 3 * H * 128], the raw bias terms [B, H, S, 64] added after the
//     scale; fp32 exponentials; the output [B, S, H * 128] with its pad
//     lanes written as zeros (P::kLanes > HD);
//   - K4 fused_global_attention (sam_global_attention.cu): hd 80 (and hd
//     64: ViT-L and ViT-B), q, k and v three head-major tensors [N, S, HD]
//     (launched with B = N, H = 1), the raw bias terms [N, S, 64]
//     pre-scaled by 1/scale and rounded to bf16 in the core (kBiasRaw),
//     added before the scale; fp32 or bf16 exponentials.
// All write o [B, S, H * kLanes] (head h at columns h * kLanes).
//
// Bound on the card: operations. K11 at B=16 does 1.37e12 FLOP of
// products (1.39 ms at the bf16 peak) against about 1.2 GB of HBM traffic;
// K20 at B=4 3.4e11 over its 80 real lanes (0.347 ms) against about 0.2 GB.
//
// Design (K15's, flash_fwd_sm90.cu, for a non-causal 4096 x 4096 problem):
//   - One block per work item, a query tile of kM rows of one (image,
//     head): a producer warpgroup (one thread issues every TMA copy) and
//     kCW consumer warpgroups of 64 query rows each (Form below: two,
//     128 rows, setmaxnreg 24 / 240; three, 192 rows, 24 / 160, for K4 and
//     K20 at hd 64). The items run in groups of 16 (image, head) pairs,
//     query tiles outer within a group, so that a group's K and V (1.3 MB
//     a pair at hd 80) stay in L2 while its tiles run. One block an SM.
//   - TMA over 4-D views: q/k/v as {d, part * H + h, row, image} (row
//     stride 3 * H * kLanes * 2 bytes, head stride kLanes * 2: only the HD
//     real lanes of each block are read; K4's three tensors as three views
//     {d, 1, row, image}, row stride 160 bytes), read as two 64-column
//     boxes with the 128-byte swizzle that wgmma reads, Q's box kM rows
//     tall and K's and V's 128. At hd 80
//     the second box holds columns 64-79 and TMA fills 80-127 with zeros,
//     so both kernels share K15's tile layout and descriptors: Q K^T runs
//     HD / 16 k-steps of wgmma.m64n128k16 (5 at hd 80), and O += P V runs
//     m64n64k16 on the first 64 columns and m64n(HD - 64)k16 on the rest.
//     At hd 64 one box holds the whole head: no second box is loaded (a
//     tile's copies expect 16 KB), Q K^T takes 4 k-steps and P V the
//     m64n64k16 products alone.
//     The tiles leave room for two stages: K and V have rings of
//     their own with separate full and empty barriers, a K stage freed
//     once its scores are read and a V stage once its product is done, so
//     each copy is issued a whole key tile before it is needed.
//   - The bias terms of the query tile come in once, with Q: TMA copies
//     [kM rows][64] of A and of B into two tables (128-byte swizzle, so
//     a quad's reads hit distinct banks). In the m64n128 accumulator
//     layout a thread's 32 columns of a row meet 16 distinct t % 64, the
//     same for every key tile: those B terms stay in registers (8 bf16
//     pairs a row), and A[s][t / 64] takes two values a row per 128-key
//     tile, read from the table. Nothing is contracted for the bias.
//     Raw terms (K4) are pre-scaled at those two reads: bf16(x * (1 /
//     scale)), as the TPU wrapper does on the XLA side.
//   - Scores in base-2 units with scale * log2(e) folded in and exp2; with
//     EXPBF16 (the TPU kernel's serving form) s - m is rounded to bf16,
//     exponentiated, the probability rounded to bf16 and l sums the
//     rounded values, each rounding one packed conversion a pair. P goes
//     to bf16 from the accumulator registers into the register A operand
//     of P V. The int8 sums become floats by an integer add and a float
//     subtract, exponentials are ex2.approx.ftz: full-rate operations in
//     place of quarter-rate ones where they exist.
//   - A warpgroup issues Q K^T of tile j with P V of tile j - 1 and runs
//     tile j's softmax while that P V runs; the warpgroups take turns in a
//     ring to issue their products (FA3's ping-pong on named barriers 1 ..
//     kCW: warpgroup cw waits on 1 + cw, then lets the next one go).
//   - DOTS_I8 (K11's int8 score form): a pre-pass (sam_global_attention_y.cu)
//     quantizes each row once per layer: q and k codes in 128-byte rows
//     (int8, zero past hd 80; at hd 64 the 64 codes in bf16), their fp32
//     scales, the codes of each row's [A | B] (in bf16, exact) and its
//     scale. The core loads Q's and each K tile's codes by TMA (16 KB
//     tiles, the same swizzle) with the key scales, runs Q K^T at hd 80 as
//     three wgmma.m64n128k32 s8 steps into s32 sums,
//     and forms float(acc) * (qs * ks) + float(ca + cb) * abss, in that
//     order, before the scale (B1: below). P V stays bf16.
//   - B1 (every form at hd 64: ViT-L's and ViT-B's global blocks, one image
//     a `SamPredictor` encode): a tile's products shrink
//     to 4 k-steps of Q K^T and P V on m64n64 alone, while the exponentials
//     and bias adds a score stay those of hd 80, so the softmax, not the
//     tensor cores, sets the pace. The scores stay in q.k units
//     (x = s + A + B, two adds) and take the row max there; p = exp2(x * c
//     - m * c) is one fma and an ex2 a score (c = scale * log2(e)), with
//     EXPBF16 d = bf16(x * scale - m * scale) and p = bf16(exp(d)), whose
//     row sums l come from the tensor cores: P V takes an m64n8k16 product
//     against a tile of ones beside its m64n64k16 ones. DOTS_I8 holds its
//     codes as bf16 (CODES16: the pre-pass writes them so), so Q K^T runs
//     as the bf16 form's and its fp32 sums are the exact integer sums: no
//     conversion of an s32 sum, which cost two operations a score, while
//     the int8 products did not shorten this loop. Its scores are kept in
//     units of q.k / qs, x = acc * ks + (ca + cb) * abss / qs (one fma and
//     one add), the row's qs riding the exponent's factor: as many
//     operations a score as the bf16 form. Weighed and left out: more K/V
//     stages (four gained nothing), dropping the ping-pong (both warp-
//     groups' softmaxes then meet on the same schedulers: slower), bf16
//     rounding by integer operations in place of the packed conversion
//     (slower), and 64-byte int8 code rows (moot with bf16 codes).
//   - Three consumer warpgroups (K4 and K20 at hd 64; K11 keeps two): each
//     sub-partition runs three consumer warps, so two warpgroups' products
//     run under the third's softmax (FA3's forward at head dim 64). 192-row
//     query tiles: 4096 = 21 * 192 + 64, so an (image, head)'s last tile
//     holds 64 rows; TMA fills Q's and the tables' rows past 4096 with
//     zeros, and those rows' stores are skipped. setmaxnreg 24 / 160 leaves
//     no room for 32 B terms held as floats, so the B1 arithmetic changes
//     shape (INIT): each thread writes its B terms once as floats into
//     shared memory (rows padded to 72 floats against bank conflicts), in
//     q.k units (K4's pre-scaled as at their
//     reads, K20's times 1 / scale in fp32); before a tile's Q K^T it fills
//     the accumulator with A + B (one add a score, 16 float2 reads a tile),
//     and the wgmma accumulates q.k onto it, so x needs no add at all and
//     K20's after-scale terms take K4's exponent. Weighed on an H100 and
//     left out (`PERF.md`): bf16 pairs read and widened a tile, the row
//     sums by a ones column with fp32 exponentials, a third K/V stage,
//     dropping the ring's turns (slower), and the two-warpgroup B1 form
//     for K4 and K20 (faster at ViT-L's 16 pairs, 352 blocks on 132 SMs,
//     slower at ViT-B's 12, 264 blocks). Exponentials replaced by two adds
//     left the time unchanged: the MUFU unit does not set it, so no share
//     of them moves to a polynomial on the FMA pipe.
// No row is ever fully masked (no mask): the core assumes a finite row
// max after the first tile, S = 4096 and W = 64.
//
// Compiled with
//   ULLAVA_MUTANT_I8_TILE_SCALE           every key of a K tile dequantized
//                                         with the tile's first key's scale;
//   ULLAVA_MUTANT_PACKED_BIAS_PRESCALED   the after-scale form adds the bias
//                                         before the scale (as if it arrived
//                                         pre-scaled by 1/scale);
//   ULLAVA_MUTANT_GLOBAL_A_ONE_ROW        the A term of a tile's first grid
//                                         row, A[s][2j], used for both halves;
//   ULLAVA_MUTANT_GLOBAL_BIAS_RAW         raw bias terms (kBiasRaw) read
//                                         without the 1/scale pre-scale;
//   ULLAVA_MUTANT_GLOBAL_B1_B_PAIR        B1: a column pair's second score
//                                         takes the pair's first B term;
//   ULLAVA_MUTANT_GLOBAL_ONES_FIRST_KSTEP B1 with EXPBF16: the row sums
//                                         take a tile's first 16 keys only;
//   ULLAVA_MUTANT_GLOBAL_B1_QS_UNFOLDED   B1 with DOTS_I8: the exponent's
//                                         factor without the row's qs;
//   ULLAVA_MUTANT_GLOBAL_TAIL_ROWS_SHIFTED the last, 64-row query tile of a
//                                         192-row schedule stores its rows
//                                         at the previous tile's offset;
//   ULLAVA_MUTANT_PACKED_PAD_LANES_UNWRITTEN the output's pad lanes (K20)
//                                         left as they were;
// it builds deliberate bugs that only `chip_smoke.py` builds, to show that
// the gates catch them.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace ullava {
namespace glob {

using sm90::smem_u32;
using sm90::mbar_init;
using sm90::mbar_expect_tx;
using sm90::mbar_arrive;
using sm90::mbar_wait;
using sm90::tma_load;
using sm90::desc_sw128;
using sm90::desc_plain;
using sm90::wgmma_fence;
using sm90::wgmma_commit;
using sm90::wgmma_wait;
using sm90::reg_fence;
using sm90::wgmma_qk;
using sm90::wgmma_qk_first;
using sm90::wgmma_qk_s8_first;
using sm90::wgmma_qk_s8;
using sm90::wgmma_pv;
using sm90::wgmma_pv16;
using sm90::wgmma_pv8;
using sm90::quad_max;
using sm90::quad_sum;
using sm90::pack_bf16;
using sm90::encode_tiled;
using sm90::encode_map;

constexpr int kW = 64;            // grid side
constexpr int kS = kW * kW;       // tokens
constexpr int kN = 128;           // keys a tile
constexpr int kTiles = kS / kN;   // key tiles an item
constexpr int kGroup = 16;        // (image, head) pairs a group of the block order
constexpr uint32_t kHalf = 128 * 128;  // bytes of one 64-column half of a 128-row bf16 tile
constexpr uint32_t kTile = 2 * kHalf;  // a bf16 tile: 32 KB
constexpr uint32_t kCodes = 128 * 128;  // 128 rows of 128 int8 codes (hd 64: of 64 bf16 codes)
constexpr uint32_t kOnes = 256;         // an n8 x k16 bf16 tile of ones
constexpr uint32_t kScales = kN * 4;    // a K tile's fp32 scales
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;              // K ring and V ring

// Every form at hd 64 (K11's pre-scaled terms, K4's raw ones, K20's after
// the scale): the B=1 schedule of the header's B1 design item.
template <class P>
__host__ __device__ constexpr bool b1_form() {
  return P::kHD == 64;
}

// The form of problem type P: kCW consumer warpgroups of 64 query rows
// (three for the hd 64 forms of K4 and K20, `kWide`; two for every other),
// kM query rows a block, kMt query tiles an (image, head) (the last one
// short where kM does not divide S), the block's threads; ONES, the row
// sums by the tensor cores (B1 with EXPBF16).
template <class P, bool EXPBF16 = false>
struct Form {
  static constexpr bool kWide = P::kHD == 64 && (P::kBiasRaw || P::kBiasAfterScale);
  static constexpr int kCW = kWide ? 3 : 2;
  static constexpr int kM = 64 * kCW;
  static constexpr int kMt = (kS + kM - 1) / kM;
  static constexpr int kThreads = 128 * (1 + kCW);
  static constexpr bool kOnes = b1_form<P>() && EXPBF16;
};

// Shared memory, from a 1024-aligned base: Q | K ring | V ring | A | B |
// key scales (DOTS_I8) | ones (ONES) | B as floats (three consumer
// warpgroups) | mbarriers. Two consumer warpgroups keep 32 KB a bf16 tile
// at any head width; three (hd 64 only) take 16 KB K and V tiles and
// 192-row Q and tables.
// A row of 64 B terms as floats, padded to 72: a warp's float2 reads (8
// rows, 32 bytes each) then take the two wavefronts their 256 bytes need.
constexpr uint32_t kBF32Row = 72 * 4;
template <bool DOTS, bool ONES = false, int CW = 2>
struct Layout {
  static constexpr uint32_t kRows = 64 * CW;  // query rows
  static constexpr uint32_t kQ = DOTS ? kCodes : CW == 2 ? kTile : kRows * 128;
  static constexpr uint32_t kK = DOTS ? kCodes : CW == 2 ? kTile : kHalf;
  static constexpr uint32_t kV = CW == 2 ? kTile : kHalf;
  static constexpr uint32_t kTable = kRows * 128;  // [kRows][64] bf16 bias terms
  static constexpr uint32_t k_off = kQ;
  static constexpr uint32_t v_off = k_off + kStages * kK;
  static constexpr uint32_t a_off = v_off + kStages * kV;
  static constexpr uint32_t b_off = a_off + kTable;
  static constexpr uint32_t ks_off = b_off + kTable;
  static constexpr uint32_t ones_off = ks_off + (DOTS ? kStages * kScales : 0);
  static constexpr uint32_t bf_off = ones_off + (ONES ? kOnes : 0);
  static constexpr uint32_t bar_off = bf_off + (CW == 3 ? kRows * kBF32Row : 0);
  static constexpr size_t kSmem = 1024 + bar_off + 8 * (1 + 4 * kStages);
};

template <class P, bool EXPBF16, bool DOTS>
using LayoutOf = Layout<DOTS, Form<P, EXPBF16>::kOnes, Form<P>::kCW>;

// The lanes of a q/k/v head block and of an output head: the head width
// where a problem type does not pad its heads (P::kLanes).
template <class P, class = void>
struct LanesOf {
  static constexpr int value = P::kHD;
};
template <class P>
struct LanesOf<P, std::void_t<decltype(P::kLanes)>> {
  static constexpr int value = P::kLanes;
};

struct Params {
  bf16* o;              // [B, S, H, HD]
  const float* scales;  // DOTS_I8: [2, B, H, S], q's then k's
  const float* abss;    // DOTS_I8: [B, H, S], the [A | B] rows' scales
  int B, H;
  float sl2;        // scale * log2(e); scale with EXPBF16
  float inv_scale;  // 1 / scale: the pre-scale of raw bias terms (P::kBiasRaw; INIT: K20's too)
};

// Item w: (image, head) pairs in groups of kGroup, query tiles outer
// within a group, so the group's K and V stay in L2 while it runs.
struct Work {
  int b, h, q0;
};
template <int M, int Mt>
__device__ __forceinline__ Work work_item(int B, int H, int w) {
  const int bh_count = B * H;
  const int G = min(kGroup, bh_count);
  const int per_group = G * Mt;
  const int grp = w / per_group, in_g = w % per_group;
  const int g_size = min(G, bh_count - grp * G);
  const int bh = grp * G + in_g % g_size;
  return Work{bh / H, bh % H, (in_g / g_size) * M};
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
// An int32 of magnitude below 2^22 as a float, exactly: its bits added to
// those of 1.5 * 2^23, minus 1.5 * 2^23 (two full-rate operations in place
// of one quarter-rate conversion). The int8 products here stay below
// 127 * 127 * 96 < 2^21.
__device__ __forceinline__ float small_int_to_float(uint32_t v) {
  return __uint_as_float(v + 0x4b400000u) - 12582912.f;
}
// 2^x on the MUFU unit, results below 2^-126 flushed to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 32-bit word at byte `byte` (a multiple of 4) of row `row` of a
// [128][128-byte] table written by TMA with the 128-byte swizzle.
__device__ __forceinline__ uint32_t table_word(uint32_t table, int row, int byte) {
  uint32_t v;
  const uint32_t addr = table + row * 128 + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15));
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The bias-term layout of K11 and K4 (K4 with H = 1): [B, S, H, 64] bf16
// as the view {j, h, s, b}, a query tile's rows of one head a box.
struct BiasBSHW {
  __device__ static void bias_coord(int b, int h, int q0, int (&c)[4]) {
    c[0] = 0;
    c[1] = h;
    c[2] = q0;
    c[3] = b;
  }
  static bool make_bias_map(CUtensorMap* map, const void* t, int B, int H, int rows) {
    const cuuint64_t dims[4] = {kW, static_cast<cuuint64_t>(H), kS, static_cast<cuuint64_t>(B)};
    const cuuint64_t row = 128ull * H;
    const cuuint64_t strides[3] = {128, row, row * kS};
    const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
    return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, t, dims, strides, box,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  }
};

// bf16(x * inv) of both halves of a bf16 pair, each rounded once.
__device__ __forceinline__ uint32_t prescale_pair(uint32_t v, float inv) {
#ifdef ULLAVA_MUTANT_GLOBAL_BIAS_RAW
  return v;
#else
  return pack_bf16(bf_lo(v) * inv, bf_hi(v) * inv);
#endif
}

// P: the problem type. P::kHD (64 or 80), P::kBiasAfterScale,
// P::kBiasRaw (the bias terms arrive raw: pre-scale them by 1/scale),
// P::kLanes where the heads are padded (K20: 128), the TMA coordinates of
// the query tile's bias rows and the head coordinates of head h's k and v
// blocks in their views.
template <class P, bool EXPBF16, bool DOTS>
__global__ void __launch_bounds__(Form<P>::kThreads, 1)
    global_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b,
                       const __grid_constant__ CUtensorMap tm_codes,
                       const __grid_constant__ CUtensorMap tm_scales, const Params p) {
  constexpr int HD = P::kHD;
  constexpr int NH = HD - 64;  // output columns of the second half: 0 or 16
  // Bytes of a bf16 K or V tile: at hd 64 one 64-column box holds a row.
  constexpr uint32_t kTileBytes = NH > 0 ? kTile : kHalf;
  constexpr bool AFTER = P::kBiasAfterScale;
  using F = Form<P, EXPBF16>;
  constexpr int CW = F::kCW, M = F::kM, Mt = F::kMt;
  constexpr int LANES = LanesOf<P>::value;
  constexpr uint32_t kQBytes = M * 128 * (NH > 0 ? 2 : 1);
  static_assert(HD == 64 || HD == 80, "hd 64 or 80");
  static_assert(LANES >= HD && LANES <= 128 && (LANES - HD) % 8 == 0, "16-byte pad chunks");
  static_assert(!(AFTER && (DOTS || EXPBF16)), "the after-scale form is K20's: bf16, fp32 exp");
  static_assert(!(P::kBiasRaw && (AFTER || DOTS)), "raw terms are K4's: before the scale, bf16");
  static_assert(CW == 2 || (HD == 64 && !DOTS), "three consumer warpgroups: K4 and K20 at hd 64");
  constexpr bool B1 = b1_form<P>();
  constexpr bool ONES = F::kOnes;  // l summed by the tensor cores
  // B1's DOTS_I8 codes are bf16 (exact small integers): Q K^T runs on the
  // bf16 tensor cores and its fp32 sums are the int8 product's, exactly.
  constexpr bool CODES16 = DOTS && B1;
  // Three consumer warpgroups (K4 and K20 at hd 64): each tile's bias
  // terms are the starting value of its Q K^T accumulator, the B terms
  // read a tile from a float copy in shared memory (INIT).
  constexpr bool INIT = CW == 3;
  using L = LayoutOf<P, EXPBF16, DOTS>;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t sQ = base;
  auto sK = [&](int s) { return base + L::k_off + L::kK * s; };
  auto sV = [&](int s) { return base + L::v_off + L::kV * s; };
  const uint32_t sA = base + L::a_off, sB = base + L::b_off;
  const uint32_t sOnes = base + L::ones_off;
  const uint32_t sBF = base + L::bf_off;
  auto sKs = [&](int s) { return base + L::ks_off + kScales * s; };
  const uint32_t bar_q = base + L::bar_off;
  auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto empty_k = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return bar_q + 8 * (1 + 3 * kStages + s); };

  const Work it = work_item<M, Mt>(p.B, p.H, blockIdx.x);
  const int H = p.H;

  if constexpr (ONES) {  // bf16 1.0 pairs, for the wgmma that sums P's rows
    if (threadIdx.x < kOnes / 4)
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sOnes + 4 * threadIdx.x), "r"(0x3f803f80u)
                   : "memory");
    sm90::fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 4 * CW);
      mbar_init(empty_v(s), 4 * CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy; the rest of the warpgroup
    // gives its registers back and ends.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int bc[4];
      P::bias_coord(it.b, it.h, it.q0, bc);
      mbar_expect_tx(bar_q, (DOTS ? L::kQ : kQBytes) + 2 * L::kTable);
      if constexpr (DOTS) {
        tma_load(sQ, &tm_codes, bar_q, 0, it.q0, it.h, it.b);
      } else {
        tma_load(sQ, &tm_q, bar_q, 0, it.h, it.q0, it.b);
        if constexpr (NH > 0) tma_load(sQ + kHalf, &tm_q, bar_q, 64, it.h, it.q0, it.b);
      }
      tma_load(sA, &tm_a, bar_q, bc[0], bc[1], bc[2], bc[3]);
      tma_load(sB, &tm_b, bar_q, bc[0], bc[1], bc[2], bc[3]);
      const int kh = P::k_head(it.h, H), vh = P::v_head(it.h, H);
      for (int j = 0; j < kTiles; ++j) {
        const int s = j % kStages, k0 = j * kN;
        if (j >= kStages) mbar_wait(empty_k(s), ((j / kStages) - 1) & 1);
        if constexpr (DOTS) {
          mbar_expect_tx(full_k(s), kCodes + kScales);
          tma_load(sK(s), &tm_codes, full_k(s), 0, k0, it.h, p.B + it.b);
          tma_load(sKs(s), &tm_scales, full_k(s), k0, it.h, p.B + it.b, 0);
        } else {
          mbar_expect_tx(full_k(s), kTileBytes);
          tma_load(sK(s), &tm_k, full_k(s), 0, kh, k0, it.b);
          if constexpr (NH > 0) tma_load(sK(s) + kHalf, &tm_k, full_k(s), 64, kh, k0, it.b);
        }
        if (j >= kStages) mbar_wait(empty_v(s), ((j / kStages) - 1) & 1);
        mbar_expect_tx(full_v(s), kTileBytes);
        tma_load(sV(s), &tm_v, full_v(s), 0, vh, k0, it.b);
        if constexpr (NH > 0) tma_load(sV(s) + kHalf, &tm_v, full_v(s), 64, vh, k0, it.b);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63.
  if constexpr (CW == 3)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, tq = lane % 4;  // row in the 8-row group, thread in quad
  const int lr[2] = {cw * 64 + warp * 16 + g, cw * 64 + warp * 16 + g + 8};  // tile rows
  float o_lo[32], o_hi[NH > 0 ? NH / 2 : 1];  // output columns 0-63 and 64 .. HD - 1
#pragma unroll
  for (int i = 0; i < 32; ++i) o_lo[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) o_hi[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float l_acc[4] = {0.f, 0.f, 0.f, 0.f};  // ONES: P's row sums, rows g and g + 8
  float sc[64];       // this tile's scores, then its probabilities
  uint32_t si[DOTS && !CODES16 ? 64 : 1];  // DOTS_I8: this tile's int8 products
  uint32_t pa[32];    // the previous tile's P, the register A operand of its P V
  float alpha[2];
  float qs[2] = {0.f, 0.f}, abss[2] = {0.f, 0.f};  // DOTS_I8: the rows' scales

  mbar_wait(bar_q, 0);
  if constexpr (DOTS) {
    const size_t row0 = static_cast<size_t>(it.b * H + it.h) * kS + it.q0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qs[r] = p.scales[row0 + lr[r]];
      abss[r] = p.abss[row0 + lr[r]];
    }
  }
  // INIT: the terms in q.k units: K4's raw ones pre-scaled as at their
  // reads, bf16(x * (1 / scale)); K20's after-scale ones times 1 / scale in
  // fp32 (`ULLAVA_MUTANT_PACKED_BIAS_PRESCALED`: as if they arrived so).
  auto init_terms = [&](uint32_t v, float& lo, float& hi) {
    if constexpr (P::kBiasRaw) {
      v = prescale_pair(v, p.inv_scale);
      lo = bf_lo(v);
      hi = bf_hi(v);
    } else {
#ifdef ULLAVA_MUTANT_PACKED_BIAS_PRESCALED
      const float inv = 1.f;
#else
      const float inv = p.inv_scale;
#endif
      lo = bf_lo(v) * inv;
      hi = bf_hi(v) * inv;
    }
  };
  // INIT: each thread's B terms as floats, in rows of kBF32Row bytes; a
  // thread writes and reads only its own (row lr[r], columns 8 c8 + 2 tq
  // and + 1).
  auto bf32_at = [&](int r, int c8) {
    return reinterpret_cast<float2*>(smem_raw + (sBF + lr[r] * kBF32Row + (8 * c8 + 2 * tq) * 4 -
                                                 smem_u32(smem_raw)));
  };
  if constexpr (INIT) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        float2 b;
        init_terms(table_word(sB, lr[r], 16 * c8 + 4 * tq), b.x, b.y);
#ifdef ULLAVA_MUTANT_GLOBAL_B1_B_PAIR
        b.y = b.x;  // a pair's first B for both
#endif
        *bf32_at(r, c8) = b;
      }
  }
  // The B terms this thread's columns meet, the same in every key tile:
  // row lr[r], columns 8 c + 2 tq (+1) for c = 0..7, as bf16 pairs; B1:
  // as floats (DOTS_I8: the codes times abss / qs), column 2 c + e; INIT:
  // in shared memory (above).
  // B1 with DOTS_I8: the rows' exponent factors (scale times qs; with
  // EXPBF16 in natural units) and abss / qs, which scales the bias codes.
  float es[2] = {p.sl2, p.sl2}, rq[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < 2 && DOTS; ++r) {
#ifdef ULLAVA_MUTANT_GLOBAL_B1_QS_UNFOLDED
    es[r] = p.sl2;
#else
    es[r] = qs[r] * p.sl2;
#endif
    rq[r] = __fdiv_rn(abss[r], qs[r]);
  }
  uint32_t bt[2][8];
  float bq[B1 && !INIT ? 2 : 1][B1 && !INIT ? 16 : 1];
  if constexpr (!INIT) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        bt[r][c] = table_word(sB, lr[r], 16 * c + 4 * tq);
        if constexpr (P::kBiasRaw) bt[r][c] = prescale_pair(bt[r][c], p.inv_scale);
        if constexpr (B1) {
          bq[r][2 * c] = DOTS ? bf_lo(bt[r][c]) * rq[r] : bf_lo(bt[r][c]);
          bq[r][2 * c + 1] = DOTS ? bf_hi(bt[r][c]) * rq[r] : bf_hi(bt[r][c]);
        }
      }
  }

  const uint32_t q_wg = sQ + cw * 64 * 128;  // this warpgroup's 64 rows of Q (each half)
  auto qk = [&](int s) {  // S = Q K^T of stage s, issued (not waited for)
    if constexpr (DOTS && !CODES16) {
      wgmma_qk_s8_first(si, desc_sw128(q_wg), desc_sw128(sK(s)));
#pragma unroll
      for (int kk = 1; kk < (HD + 31) / 32; ++kk)
        wgmma_qk_s8(si, desc_sw128(q_wg + kk * 32), desc_sw128(sK(s) + kk * 32));
    } else if constexpr (INIT) {  // onto the tile's bias terms in sc
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_qk(sc, desc_sw128(q_wg + (kk % 4) * 32), desc_sw128(sK(s) + (kk % 4) * 32), 1);
    } else {
      wgmma_qk_first(sc, desc_sw128(q_wg), desc_sw128(sK(s)));
#pragma unroll
      for (int kk = 1; kk < HD / 16; ++kk)
        wgmma_qk(sc, desc_sw128(q_wg + (kk / 4) * kHalf + (kk % 4) * 32),
                 desc_sw128(sK(s) + (kk / 4) * kHalf + (kk % 4) * 32), 1);
    }
    wgmma_commit();
  };
  auto pv = [&](int s) {  // O += P V of stage s with the P in pa, issued
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      wgmma_pv(o_lo, pa + 4 * kk, desc_sw128(sV(s) + kk * 2048));
#ifdef ULLAVA_MUTANT_GLOBAL_ONES_FIRST_KSTEP
      if (ONES && kk == 0) wgmma_pv8(l_acc, pa + 4 * kk, desc_plain(sOnes));
#else
      if constexpr (ONES) wgmma_pv8(l_acc, pa + 4 * kk, desc_plain(sOnes));
#endif
      if constexpr (NH == 16)
        wgmma_pv16(o_hi, pa + 4 * kk, desc_sw128(sV(s) + kHalf + kk * 2048));
    }
    wgmma_commit();
  };
  // Tile j's scores with the bias (and, DOTS_I8, the scales), in the
  // exponentials' units; the new row max, alpha = exp(m_old - m_new),
  // p = exp(s - m_new) into sc and its sum into l (l scaled by alpha).
  auto softmax = [&](int j, int s) {
    float a_lo[2], a_hi[2];  // A[s][2 j], A[s][2 j + 1]: key grid rows of the tile's halves
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t a2 = table_word(sA, lr[r], 4 * j);
      if constexpr (P::kBiasRaw) a2 = prescale_pair(a2, p.inv_scale);
      a_lo[r] = bf_lo(a2);
#ifdef ULLAVA_MUTANT_GLOBAL_A_ONE_ROW
      a_hi[r] = a_lo[r];
#else
      a_hi[r] = bf_hi(a2);
#endif
    }
    const float* ks = nullptr;
    if constexpr (DOTS && !CODES16) {
      ks = reinterpret_cast<const float*>(smem_raw + (sKs(s) - smem_u32(smem_raw)));
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = small_int_to_float(si[i]);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1, c = i >> 2, e = i & 1;
      const uint32_t b2 = bt[r][c & 7];
      const float bias = (c < 8 ? a_lo[r] : a_hi[r]) + (e ? bf_hi(b2) : bf_lo(b2));
      float x = sc[i];
      if constexpr (DOTS) {
#ifdef ULLAVA_MUTANT_I8_TILE_SCALE
        const float k_scale = ks[0];
#else
        const float k_scale = ks[8 * c + 2 * tq + e];
#endif
        // float(acc) * (qs * ks) + float(ca + cb) * abss; the code sum is exact.
        x = __fadd_rn(__fmul_rn(x, __fmul_rn(qs[r], k_scale)), __fmul_rn(bias, abss[r])) *
            p.sl2;
      } else if constexpr (AFTER) {
#ifdef ULLAVA_MUTANT_PACKED_BIAS_PRESCALED
        x = (x + bias) * p.sl2;  // the bias read as if pre-scaled by 1/scale
#else
        x = x * p.sl2 + bias * kLog2e;  // q.k * scale + A + B, in base-2 units
#endif
      } else {
        x = (x + bias) * p.sl2;
      }
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = exp2_ftz(EXPBF16 ? (m_run[r] - m_new) * kLog2e : m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
    if constexpr (EXPBF16) {
      // A pair of a row at a time, each rounding one packed conversion:
      // d = bf16(s - m), p = bf16(exp(d)); l sums the rounded p, and the
      // packed pair, already P's bf16 operand, is kept in sc[i].
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = (i >> 1) & 1;
        const uint32_t d2 = pack_bf16(sc[i] - m_run[r], sc[i + 1] - m_run[r]);
        const uint32_t p2 = pack_bf16(exp2_ftz(bf_lo(d2) * kLog2e), exp2_ftz(bf_hi(d2) * kLog2e));
        l_run[r] += bf_lo(p2) + bf_hi(p2);
        sc[i] = __uint_as_float(p2);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2_ftz(sc[i] - m_run[r]);
        l_run[r] += sc[i];
      }
    }
  };
  // B1: the scores in q.k units, x = s + A + B, and their row max m; then
  // p = exp2(x * c - m * c) with c = scale * log2(e), one fma a score, or
  // with EXPBF16 d = bf16(x * scale - m * scale), p = bf16(exp(d)), whose
  // row sums the ones column of P V takes (ONES). DOTS_I8 keeps x in units
  // of q.k / qs, so the row's q scale rides the exponent's factor: x =
  // acc * ks + (ca + cb) * abss / qs, one fma on the exact integer sum acc
  // (CODES16) and the key's scale. INIT: Q K^T started from A + B, so x is
  // the accumulator as it stands.
  auto softmax_b1 = [&](int j, int s) {
    float a_lo[2], a_hi[2];
#pragma unroll
    for (int r = 0; r < 2 && !INIT; ++r) {
      const uint32_t a2 = table_word(sA, lr[r], 4 * j);
      a_lo[r] = DOTS ? bf_lo(a2) * rq[r] : bf_lo(a2);
#ifdef ULLAVA_MUTANT_GLOBAL_A_ONE_ROW
      a_hi[r] = a_lo[r];
#else
      a_hi[r] = DOTS ? bf_hi(a2) * rq[r] : bf_hi(a2);
#endif
    }
    const float* ks = nullptr;
    if constexpr (DOTS) ks = reinterpret_cast<const float*>(smem_raw + (sKs(s) - smem_u32(smem_raw)));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1, c = i >> 2, e = i & 1;
      if constexpr (INIT) {  // the bias is in the scores already
        mx[r] = fmaxf(mx[r], sc[i]);
      } else {
#ifdef ULLAVA_MUTANT_GLOBAL_B1_B_PAIR
        const float bias = (c < 8 ? a_lo[r] : a_hi[r]) + bq[r][2 * (c & 7)];  // a pair's first B
#else
        const float bias = (c < 8 ? a_lo[r] : a_hi[r]) + bq[r][2 * (c & 7) + e];
#endif
        float x;
        if constexpr (DOTS) {
#ifdef ULLAVA_MUTANT_I8_TILE_SCALE
          const float k_scale = ks[0];
#else
          const float k_scale = ks[8 * c + 2 * tq + e];
#endif
          x = __fmaf_rn(sc[i], k_scale, bias);
        } else {
          x = sc[i] + bias;
        }
        sc[i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float nm[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      const float e = DOTS ? es[r] : p.sl2;
      alpha[r] = exp2_ftz((m_run[r] - m_new) * (EXPBF16 ? e * kLog2e : e));
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
      nm[r] = -m_new * e;
    }
    if constexpr (EXPBF16) {
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = (i >> 1) & 1;
        const float e = DOTS ? es[r] : p.sl2;
        const uint32_t d2 = pack_bf16(__fmaf_rn(sc[i], e, nm[r]), __fmaf_rn(sc[i + 1], e, nm[r]));
        sc[i] = __uint_as_float(
            pack_bf16(exp2_ftz(bf_lo(d2) * kLog2e), exp2_ftz(bf_hi(d2) * kLog2e)));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2_ftz(__fmaf_rn(sc[i], DOTS ? es[r] : p.sl2, nm[r]));
        l_run[r] += sc[i];
      }
    }
  };
  // INIT: sc = A[s][t / 64] + B[s][t % 64] of tile j in q.k units, which
  // Q K^T then accumulates onto.
  auto bias_init = [&](int j) {
    float a_lo[2], a_hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      init_terms(table_word(sA, lr[r], 4 * j), a_lo[r], a_hi[r]);
#ifdef ULLAVA_MUTANT_GLOBAL_A_ONE_ROW
      a_hi[r] = a_lo[r];
#endif
    }
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 b = *bf32_at(r, c8);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          sc[4 * (c8 + 8 * hf) + 2 * r] = (hf ? a_hi[r] : a_lo[r]) + b.x;
          sc[4 * (c8 + 8 * hf) + 2 * r + 1] = (hf ? a_hi[r] : a_lo[r]) + b.y;
        }
      }
    reg_fence(sc);
  };
  // P as the register A operand: for keys 16 kk .. + 15, the accumulator
  // pairs 8 kk .. 8 kk + 7 in order (rows g, g + 8; columns 2 tq, + 8).
  auto to_pa = [&] {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      pa[i] = EXPBF16 ? __float_as_uint(sc[2 * i]) : pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  auto rescale = [&] {
#pragma unroll
    for (int i = 0; i < 32; ++i) o_lo[i] *= alpha[(i >> 1) & 1];
    if constexpr (ONES) {
#pragma unroll
      for (int i = 0; i < 4; ++i) l_acc[i] *= alpha[i >> 1];
    }
#pragma unroll
    for (int i = 0; i < NH / 2; ++i) o_hi[i] *= alpha[(i >> 1) & 1];
  };
  auto fence_o = [&] {
    reg_fence(o_lo);
    if constexpr (NH > 0) reg_fence(o_hi);
    if constexpr (ONES) reg_fence(l_acc);
  };
  auto softmax_any = [&](int j, int s) {
    if constexpr (B1)
      softmax_b1(j, s);
    else
      softmax(j, s);
  };
  auto fence_s = [&] {
    if constexpr (DOTS && !CODES16)
      reg_fence(si);
    else
      reg_fence(sc);
  };

  // Ping-pong in a ring: the warpgroups take turns to issue their products
  // (named barriers 1 .. CW: warpgroup cw waits on 1 + cw, then lets the
  // next one go on 1 + (cw + 1) % CW). All take kTiles + 1 turns; the last
  // warpgroup opens the first and leaves out its last arrival, which no
  // turn would wait for.
  auto turn_begin = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory"); };
  auto turn_end = [&](bool last) {
    if (!(cw == CW - 1 && last))
      asm volatile("bar.arrive %0, 256;\n" ::"r"(CW == 2 ? 2 - cw : 1 + (cw + 1) % CW)
                   : "memory");
  };
  if (cw == CW - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  if constexpr (INIT) bias_init(0);
  mbar_wait(full_k(0), 0);
  turn_begin();
  wgmma_fence();
  qk(0);
  turn_end(false);
  wgmma_wait<0>();
  fence_s();
  softmax_any(0, 0);
  if (lane == 0) mbar_arrive(empty_k(0));
  to_pa();
  for (int j = 1; j < kTiles; ++j) {
    const int s = j % kStages, sp = (j - 1) % kStages;
    if constexpr (INIT) bias_init(j);
    mbar_wait(full_k(s), (j / kStages) & 1);
    mbar_wait(full_v(sp), ((j - 1) / kStages) & 1);
    reg_fence(pa);
    fence_o();
    turn_begin();
    wgmma_fence();
    qk(s);
    pv(sp);
    turn_end(false);
    wgmma_wait<1>();  // Q K^T of tile j is done
    fence_s();
    softmax_any(j, s);
    if (lane == 0) mbar_arrive(empty_k(s));
    wgmma_wait<0>();  // P V of tile j - 1 is done
    fence_o();
    reg_fence(pa);
    if (lane == 0) mbar_arrive(empty_v(sp));
    rescale();
    to_pa();
  }
  constexpr int sl = (kTiles - 1) % kStages;
  mbar_wait(full_v(sl), ((kTiles - 1) / kStages) & 1);
  reg_fence(pa);
  fence_o();
  turn_begin();
  wgmma_fence();
  pv(sl);
  turn_end(true);
  wgmma_wait<0>();
  fence_o();

  // o = acc / l, head-merged: o[b, row, h, :HD]; lanes HD .. LANES - 1 of a
  // padded head written as zeros, 16 bytes a store (8 chunks at hd 64, 6
  // at hd 80, over the quad). Rows past S (the 192-row schedule's last
  // tile) are not stored.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / (ONES ? l_acc[2 * r] : quad_sum(l_run[r]));
    int q0 = it.q0;
    if constexpr (kS % M != 0) {
#ifdef ULLAVA_MUTANT_GLOBAL_TAIL_ROWS_SHIFTED
      if (q0 + M > kS) q0 -= M;  // the short tile's rows at the previous tile's offset
#endif
      if (it.q0 + lr[r] >= kS) continue;
    }
    bf16* out = p.o + ((static_cast<size_t>(it.b) * kS + q0 + lr[r]) * H + it.h) * LANES + 2 * tq;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * i) = __floats2bfloat162_rn(
          o_lo[4 * i + 2 * r] * inv, o_lo[4 * i + 2 * r + 1] * inv);
#pragma unroll
    for (int i = 0; i < NH / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + 64 + 8 * i) = __floats2bfloat162_rn(
          o_hi[4 * i + 2 * r] * inv, o_hi[4 * i + 2 * r + 1] * inv);
    if constexpr (LANES > HD) {
#ifndef ULLAVA_MUTANT_PACKED_PAD_LANES_UNWRITTEN
      constexpr int kChunks = (LANES - HD) / 8;
      for (int c = tq; c < kChunks; c += 4)
        *reinterpret_cast<uint4*>(out - 2 * tq + HD + 8 * c) = make_uint4(0u, 0u, 0u, 0u);
#endif
    }
  }
}

// The view {d, head, row, image} of t [B, S, heads * lanes] bf16, the
// first HD lanes of each head, in 64-column boxes of `rows` rows with the
// 128-byte swizzle: y [B, S, 3 * H * lanes] with heads = 3 H (q, k, v
// blocks part * H + h), or one of K4's [N, S, HD] with heads = 1.
template <int HD>
inline bool make_qkv_map(CUtensorMap* map, const void* t, int B, int heads, int lanes, int rows) {
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * lanes * sizeof(bf16);
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads), kS, static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {lanes * sizeof(bf16), row, row * kS};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, t, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <class P, bool EXPBF16, bool DOTS>
int configure() {
  static bool configured = false;
  if (!configured) {
    if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cudaError_t err = cudaFuncSetAttribute(global_sm90_kernel<P, EXPBF16, DOTS>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(LayoutOf<P, EXPBF16, DOTS>::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

// The kernel's registers, shared bytes, spills and blocks an SM.
template <class P, bool EXPBF16, bool DOTS>
int attrs(int* out) {
  if (const int err = configure<P, EXPBF16, DOTS>()) return err;
  return func_attrs(global_sm90_kernel<P, EXPBF16, DOTS>, Form<P>::kThreads,
                    LayoutOf<P, EXPBF16, DOTS>::kSmem, out);
}

// Launches one block per (image, head, query tile of Form<P>::kM rows).
// q, k and v are one qkv output [B, S, 3 * H * lanes] passed three times
// (P::kQkvHeads 3), or three [B, S, HD] tensors (1, with H = 1); a k
// pointer apart from q (K20's across-the-block mutant) gets a view of its
// own. `codes` and `scales` are the DOTS_I8 pre-pass's outputs (unused
// otherwise).
template <class P, bool EXPBF16, bool DOTS>
int launch_global(const void* q, const void* k, const void* v, const void* a, const void* b,
                  const void* codes, const void* scales, const Params& p, cudaStream_t stream) {
  using Sc = Form<P>;
  constexpr size_t smem = LayoutOf<P, EXPBF16, DOTS>::kSmem;
  constexpr int lanes = LanesOf<P>::value;
  if (const int err = configure<P, EXPBF16, DOTS>()) return err;
  if (p.B == 0 || p.H == 0) return 0;
  CUtensorMap tm_q{}, tm_k{}, tm_v{}, tm_a{}, tm_b{}, tm_codes{}, tm_scales{};
  const int heads = P::kQkvHeads * p.H;
  const bool q_box_is_kn = Sc::kM == kN;  // Q's map serves k and v too
  bool ok = make_qkv_map<P::kHD>(&tm_q, q, p.B, heads, lanes, Sc::kM);
  if (k == q && q_box_is_kn)
    tm_k = tm_q;
  else
    ok = ok && make_qkv_map<P::kHD>(&tm_k, k, p.B, heads, lanes, kN);
  if (v == q && q_box_is_kn)
    tm_v = tm_q;
  else if (v == k)
    tm_v = tm_k;
  else
    ok = ok && make_qkv_map<P::kHD>(&tm_v, v, p.B, heads, lanes, kN);
  ok = ok && P::make_bias_map(&tm_a, a, p.B, p.H, Sc::kM) &&
       P::make_bias_map(&tm_b, b, p.B, p.H, Sc::kM);
  if constexpr (DOTS) {
    // codes [2, B, H, S, 128] int8 as {byte, row, head, 2B} (hd 64, B1:
    // [2, B, H, S, 64] bf16 as {lane, row, head, 2B}; 128-byte rows either
    // way); scales [2, B, H, S] fp32 as {row, head, 2B, 1}.
    constexpr bool codes16 = b1_form<P>();
    const cuuint64_t nb = 2ull * p.B;
    const cuuint64_t cd[4] = {codes16 ? 64u : 128u, kS, static_cast<cuuint64_t>(p.H), nb};
    const cuuint64_t cs[3] = {128, 128ull * kS, 128ull * kS * p.H};
    const cuuint32_t cbox[4] = {codes16 ? 64u : 128u, 128, 1, 1};
    const cuuint64_t sd[4] = {kS, static_cast<cuuint64_t>(p.H), nb, 1};
    const cuuint64_t ss[3] = {4ull * kS, 4ull * kS * p.H, 4ull * kS * p.H * nb};
    const cuuint32_t sbox[4] = {kN, 1, 1, 1};
    ok = ok &&
         encode_map(&tm_codes,
                    codes16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                    codes, cd, cs, cbox, CU_TENSOR_MAP_SWIZZLE_128B) &&
         encode_map(&tm_scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, sd, ss, sbox,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  global_sm90_kernel<P, EXPBF16, DOTS><<<p.B * p.H * Sc::kMt, Sc::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_a, tm_b, tm_codes, tm_scales, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace glob
}  // namespace ullava
