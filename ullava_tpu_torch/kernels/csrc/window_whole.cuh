// Whole-window attention: one block per (window, head) owns all the
// window's query rows, and each warp keeps the whole key row of its scores
// in registers, so the softmax normalises P before rounding it to bf16
// exactly where the TPU kernels do (p = exp(s - m) / sum(p), p.astype(bf16),
// P V summed in fp32 with no final division) with no scores parked in
// shared memory and no second pass over the keys. Four kernels run on it,
// each a problem type P (the accessors of its layout and its score form):
//   - K3, the grid window kernel (`_grid_kernel`,
//     ullava_tpu/ops/sam_attention.py:113-178): HD 80 (ViT-H; and HD 64,
//     ViT-L's and ViT-B's head), bias terms pre-scaled by 1/scale and
//     added before it, a window stored as Sq = 196 or `total_rows` = 200
//     rows of which the first 196 are keys;
//   - K14, the boundary-window kernel (`_rect_kernel` :261-350): HD 80
//     (and HD 64), only the T = R x C real tokens of a logical
//     WB x WB window are rows and keys (the geometry G, a template
//     parameter); the pad positions are not keys of any product
//     (P::kPadKeys, below);
//   - K19, the packed window kernel (`_packed_window_kernel` :791-822):
//     K3's function over whole windows with the raw bias terms in natural
//     column order added after the scale (P::kBiasAfterScale: s = q.k *
//     scale + A + B), on the packed layout's 128-lane head blocks. Its pad
//     lanes are zero by construction (:785-787), so it is instantiated at
//     the real head width (HD 64 or 80): it loads and contracts only those
//     lanes of each block and writes the output's P::kOutLanes - HD pad
//     lanes as zeros itself. A problem type of the body rather than a
//     branch of its own: one core to keep, and K3's cp.async prefetch of
//     the Q and bias rows in place of plain loads a tile;
//   - K21, the per-(window, head) window kernel (`_kernel` :29-67): K3's
//     function on head-major [N, 196, 80] q, k and v, its bias terms raw
//     in natural column order (P::kBiasRaw): each term is scaled by
//     1/scale and rounded to bf16 where a thread reads it, as the TPU
//     wrapper pre-scales them (:88-90).
// K3 and K14 also take the int8 score form (I8, `dots_i8`) at both HDs.
//
// Design (windows of at most kWwKeys = 208 keys: 196 for 14 x 14, padded
// to 13 chunks of 16):
//   - K and V of the instance are copied into shared memory once, with
//     16-byte cp.async copies by all the block's threads, K and V in two
//     groups so that Q K^T starts while V lands; rows past the keys are
//     zero-filled. At HD 64 rows are 128 bytes with the 16-byte chunks
//     XOR-swizzled by the row's low three bits; at HD 80 (10 chunks, for
//     which that XOR is no permutation) rows are padded to 176 bytes, 11
//     chunks, so 8 consecutive rows start in 8 distinct 16-byte bank
//     groups. Either way the ldmatrix reads of 8 rows hit 32 distinct
//     banks.
//   - The window's rows form tiles of 16 (13 for 196-208 rows, the last
//     partly live) over kWwWarps = 4 warps: warp w takes tiles w, w + 4,
//     ... and prefetches its next tile's Q rows and raw bias rows into a
//     second buffer with cp.async while one is computed. Four warps give
//     each thread 255 registers for the score row (104 fp32: 26 accumulator
//     tiles of mma.sync.m16n8k16), its two rows' bias terms (58 floats) and
//     20 (HD 80) or 16 (HD 64) Q and 40 or 32 O registers. Each warp runs S
//     = Q K^T, adds the bias terms, scales, masks the pad keys, takes the
//     row max and sum over its quad (two shuffles each), and rounds p =
//     exp(s - m) / l to bf16 straight into the A fragments of O = P V. O
//     goes out as bf16 with no final division.
//   - The bias terms A[s][a] and B[s][b] of key (a, b) (t / C, t % C for
//     compact key t of a rectangle of C columns) are read by each thread
//     into registers once a tile: its rows' A terms (key t's by a
//     compile-time index and a select) and the kPer x 2 B terms that
//     t % C cycles through.
//   - K14 (P::kPadKeys): a pad position (a, b) outside the R x C rectangle
//     has key pad_k[h][0:HD] and value pad_v[h], the same for every pad of
//     the head, so its score is (q . pad_k + A[a] + B[b]) * scale with one
//     fp32 q . pad_k a query row (from the bf16 q, as the TPU's
//     `qa . padk[h]`). The pads enter the row max and sum; their
//     probabilities are summed in fp32, unrounded, and pad_mass * pad_v is
//     added to O in fp32. Shared memory holds the T real K and V rows only:
//     no pad row is loaded and no pad key goes through an MMA (84 of 196
//     logical keys of an edge window, 132 of a corner one).
//   - I8 (`dots_i8`): the block quantizes its K rows once, in place, to
//     int8 codes (hd 80 zero-padded to 96 bytes: three k-steps of
//     mma.sync.m16n8k32; hd 64 two) with each row's scale beside them; each
//     warp quantizes its tile's Q rows (in place) and [A | B] rows. A
//     swizzled K row (HD 64) keeps the swizzle: its 16-byte code chunk c
//     lands where bf16 chunk c was, so the codes' ldmatrix reads of 8 rows
//     hit distinct banks as the bf16 ones do. Codes and
//     scales are `_row_quant`'s bit for bit: abs-max floored at 1e-12,
//     127 / amax as an IEEE division, round half to even, scale amax *
//     (1 / 127). s = (float(qk) * (qs * ks) + float(ca + cb) * abss) *
//     scale; K14's pads keep the unquantized score; P V stays bf16.
//
// The hd 64 whole windows (K3 in both score forms, K19) at B=1, the
// `SamPredictor` encode of ViT-L and ViT-B: one ViT-L image is 16 windows
// x 16 heads = 256 blocks, under one wave of two blocks an SM, each warp
// four tiles deep (192 blocks for ViT-B, 400 and 300 for K19's 25 padded
// windows). They keep the 4-warp schedule: a warp a query tile (13 warps,
// one block an SM) leaves 128 registers a thread, since four of the
// warps share one sub-partition's 16,384, under the score row's 104 plus
// the rest, and spilled; 6 and 8 warps and a (window, head) split over two
// blocks of 7 and 6 tiles were no faster (PERF.md, PR 29): the time is the
// SM's work, not the waves'. What moved them is work a score, and only
// they take it (kHd64 in the body): ex2.approx.ftz in place of exp2f's
// denormal handling and p = e * (1 / l) in place of the exact quotient
// (ww_probs). The hd 80 forms (K3, K14, K19 and K21 at ViT-H) keep exp2f
// and the exact quotient.
//
// Compiled with ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX each thread normalises its
// scores by its own partial row max instead of the quad's; with
// ULLAVA_MUTANT_I8_TILE_SCALE the int8 forms dequantize every key of a
// 16-key chunk with the chunk's first key's scale; with
// ULLAVA_MUTANT_RECT_PAD_OUT_OF_SUM K14's pad scores enter the row max but
// not the row sum; K14's hd 64 schedule with ULLAVA_MUTANT_RECT_TILE_BIAS_ROWS
// has each warp read the next warp's tile's bias rows, with
// ULLAVA_MUTANT_RECT_PAD_SUM_NO_QUAD each thread's closed-form pad sums
// left unreduced over the quad; K19 with ULLAVA_MUTANT_PACKED_BIAS_PRESCALED
// adds the bias before the scale, with
// ULLAVA_MUTANT_PACKED_PAD_LANES_UNWRITTEN leaves the output's pad lanes
// as it found them. Deliberate bugs that only `chip_smoke.py` and the card
// tests build, to show that the gates catch them.
#pragma once

#include <type_traits>

#include "flash_core.cuh"

namespace ullava {

constexpr int kWwKeys = 208;  // keys a window can hold (13 chunks of 16)
constexpr int kWwWarps = 4;  // warps a (window, head)
constexpr int kWwThreads = kWwWarps * 32;

// The real R x C rectangle of a logical window (R = C = WB: a whole one).
template <int R_, int C_>
struct WwRect {
  static constexpr int R = R_, C = C_, T = R_ * C_;
  static constexpr int NC = (T + 15) / 16;  // 16-key chunks
};

// P::kOutLanes, the lanes of an output row where a problem type has more
// than HD (K19's 128-lane head blocks); 0 where it has none.
template <class P, class = void>
struct WwOutLanes {
  static constexpr int value = 0;
};
template <class P>
struct WwOutLanes<P, std::void_t<decltype(P::kOutLanes)>> {
  static constexpr int value = P::kOutLanes;
};

__host__ __device__ constexpr int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

// Rows of HD bf16 in shared memory: with a multiple of 8 16-byte chunks a
// row the chunks are XOR-swizzled by the row's low three bits; otherwise
// the row is padded to an odd number of chunks.
template <int HD>
__host__ __device__ constexpr bool ww_swizzled() {
  return (HD / 8) % 8 == 0;
}
template <int HD>
__host__ __device__ constexpr int ww_row_bytes() {
  return ww_swizzled<HD>() ? HD * 2 : (HD / 8 % 2 ? HD * 2 : HD * 2 + 16);
}

// The byte offset of 16-byte chunk c of row r in a [rows][HD] tile.
template <int HD>
__device__ __forceinline__ int ww_offset(int r, int c) {
  static_assert(HD % 16 == 0, "rows of whole 16-byte chunk pairs");
  static_assert(ww_swizzled<HD>() || (ww_row_bytes<HD>() / 16) % 2 == 1,
                "8 consecutive rows must start in 8 distinct bank groups");
  if constexpr (ww_swizzled<HD>())
    return r * HD * 2 + ((c ^ (r & 7)) << 4);
  else
    return r * ww_row_bytes<HD>() + (c << 4);
}

// d += a (16x32, row) * b (32x8, col); int8 inputs, int32 accumulators,
// laid out as mma_bf16's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(live ? 4 : 0));
}

// 2^x by the special-function unit alone (denormal results flushed to
// zero: probabilities under 2^-126, which vanish beside the row's largest,
// 1): exp2f's denormal handling costs three more operations a score. The
// exponential of the hd 64 whole windows only (see the header).
__device__ __forceinline__ float ww_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T over NC chunks of 16 keys, bf16 Q fragments against K rows.
template <int HD, int NC>
__device__ __forceinline__ void ww_qk_bf16(float (&s)[2 * NC][4], const uint32_t (&qf)[HD / 16][4],
                                           const unsigned char* sK, int lane) {
#pragma unroll
  for (int j = 0; j < 2 * NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < NC; ++np) {  // 16 keys per ldmatrix.x4
      uint32_t b[4];
      const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4(b, reinterpret_cast<const bf16*>(
                         sK + ww_offset<HD>(r, 2 * kk + ((lane >> 3) & 1))));
      mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }
}

// p = exp(s - m) / l rounded to bf16, as the A fragments of 16-key chunks:
// P normalized before its rounding, where the TPU kernels round it. The
// quotient is the IEEE one, taken as q = a * (1 / l) and one correction
// q + (a - q l) / l with fma (Markstein: exact for a correctly rounded
// reciprocal and a normal quotient), three operations in place of the
// general division's subroutine. With ONE_ULP (the hd 64 whole windows)
// it is a * (1 / l) alone, within an ulp of the IEEE one: it moves a bf16
// rounding of p only where the quotient lies within an ulp of a rounding
// boundary.
template <int NC, bool ONE_ULP>
__device__ __forceinline__ void ww_probs(const float (&s)[2 * NC][4], const float (&l)[2],
                                         uint32_t (&pa)[NC][4]) {
  // (l is a sum of exponentials of at least one zero exponent: l >= 1.)
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float pv[2][4];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float a = s[2 * c + h2][e];
        const float q = __fmul_rn(a, rl[r]);
        pv[h2][e] = ONE_ULP ? q : __fmaf_rn(__fmaf_rn(-q, l[r], a), rl[r], q);
      }
    }
    pa[c][0] = pack_bf16(pv[0][0], pv[0][1]);
    pa[c][1] = pack_bf16(pv[0][2], pv[0][3]);
    pa[c][2] = pack_bf16(pv[1][0], pv[1][1]);
    pa[c][3] = pack_bf16(pv[1][2], pv[1][3]);
  }
}

// O = P V over the chunks that hold keys (P is 0 past the last one).
template <int HD, int NC, int KEYS>
__device__ __forceinline__ void ww_pv(float (&o)[HD / 8][4], const uint32_t (&pa)[NC][4],
                                      const unsigned char* sV, int lane) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (c * 16 >= KEYS) break;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {  // 16 output columns per ldmatrix.x4
      uint32_t b[4];
      const int r = c * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
      ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(
                               sV + ww_offset<HD>(r, 2 * np + (lane >> 4))));
      mma_bf16(o[2 * np], pa[c], b[0], b[1]);
      mma_bf16(o[2 * np + 1], pa[c], b[2], b[3]);
    }
  }
}

// The abs-max of a row whose two halves are held by the lanes lane and
// lane ^ 1, floored at 1e-12 (`_row_quant`).
__device__ __forceinline__ float ww_row_amax(float amax) {
  return fmaxf(fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1)), 1e-12f);
}

// `_row_quant` of one bf16 row of HD in place, half hf of it by this lane
// and the other half by lane ^ 1: the row becomes its int8 codes, bytes
// [HD, 32 * ceil(HD / 32)) zero, and the row's scale is returned. The
// row's 16-byte chunk c lies at chunk c ^ swz (swz = 0: in order); the
// codes keep that placement. A half is read whole before any code is
// written (the partner's codes land on this half only after the shuffle,
// which waits for these reads).
template <int HD>
__device__ __forceinline__ float ww_quantize_half_row(unsigned char* row, int hf, int swz = 0) {
  constexpr int HALF = HD / 2, KB = (HD + 31) / 32 * 32;
  static_assert(HALF % 8 == 0, "half a row of whole 16-byte chunks");
  auto at = [&](int byte) { return row + ((((byte >> 4) ^ swz) << 4) | (byte & 15)); };
  float v[HALF];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < HALF / 8; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(at(hf * HALF * 2 + c * 16));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[c * 8 + 2 * i] = f.x;
      v[c * 8 + 2 * i + 1] = f.y;
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  amax = ww_row_amax(amax);
  const float inv = __fdiv_rn(127.f, amax);
#pragma unroll
  for (int c = 0; c < HALF; c += 4) {
    uint32_t w = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w |= (static_cast<uint32_t>(__float2int_rn(__fmul_rn(v[c + i], inv))) & 0xffu) << (8 * i);
    *reinterpret_cast<uint32_t*>(at(hf * HALF + c)) = w;
  }
  if (hf == 1) {
#pragma unroll
    for (int b = HD; b < KB; b += 4) *reinterpret_cast<uint32_t*>(at(b)) = 0u;
  }
  return __fmul_rn(amax, 1.f / 127.f);
}

template <class G>
__host__ __device__ constexpr int ww_min_blocks() {
  return G::NC > 8 ? 2 : 3;
}

// The shared-memory layout of the body's blocks: K and V (NK rows each),
// the int8 K scales, the pad tables, then per warp two buffers of [16 Q
// rows | 2 x 16 raw bias rows of WB] and the bias codes (I8).
template <int HD, int WB, class P, class G, bool I8>
struct WwLayout {
  static constexpr int RB = ww_row_bytes<HD>();
  static constexpr int NK = G::NC * 16;
  static constexpr int kKV = NK * RB;
  static constexpr int kScales = I8 ? NK * 4 : 0;
  static constexpr int kPad = P::kPadKeys ? 2 * HD * 2 : 0;
  static constexpr int kBias = 2 * 16 * WB * 2;
  static constexpr int kBuf = 16 * RB + kBias;
  static constexpr int kWarp = 2 * kBuf + (I8 ? kBias : 0);
  static constexpr int kBytes = 2 * kKV + kScales + kPad + kWarp * kWwWarps;
  static_assert(kBias % 16 == 0 && kScales % 16 == 0 && kPad % 16 == 0, "16-byte sections");
};

// The block of K3, K14 (HD 80), K19 and K21 over geometry G (see the
// header).
template <int HD, int WB, class P, class G, bool I8>
__device__ __forceinline__ void ww_window_body(const P& p, unsigned char* smem_raw) {
  using L = WwLayout<HD, WB, P, G, I8>;
  constexpr int R = G::R, C = G::C, T = G::T, NC = G::NC, NK = L::NK, RB = L::RB;
  constexpr int KD = HD / 16;          // k-steps of the bf16 Q K^T
  constexpr int KD8 = (HD + 31) / 32;  // k-steps of the int8 Q K^T
  constexpr int ND = HD / 8;           // 8-wide column tiles of O
  constexpr int CPR = HD / 8;          // 16-byte chunks of a row
  constexpr int kPer = C / gcd_int(8, C);  // (8 j) % C repeats with j % kPer
  constexpr int BW = WB / 2;           // 4-byte words of a bias row
  constexpr int kOutPad = WwOutLanes<P>::value > HD ? WwOutLanes<P>::value - HD : 0;
  static_assert(C >= 8 && C <= WB && R <= WB, "a key's A index moves at most one row in 8 keys");
  static_assert(WB % 2 == 0, "bias rows of whole 4-byte words");
  static_assert(NK <= kWwKeys && (T + 15) / 16 >= kWwWarps, "every warp has a tile");
  static_assert(!I8 || KD8 * 32 <= RB, "an int8 row fits in its bf16 row");
  static_assert(!P::kBiasRaw || (!I8 && !P::kPadKeys), "raw bias terms: K21's form only");
  static_assert(!P::kBiasAfterScale || (!I8 && !P::kPadKeys && !P::kBiasRaw),
                "the after-scale form: K19's bf16 scores over whole windows");
  static_assert(kOutPad % 8 == 0, "pad lanes of whole 16-byte chunks");
  constexpr bool kHd64 = HD == 64;  // ex2.approx.ftz and p = e * (1 / l): see the header
  constexpr float kLog2e = 1.4426950408889634f;
  // Bias term `col` of a staged row: reversed and pre-scaled (K3, K14),
  // natural and raw, pre-scaled here (K21), or natural and raw, added after
  // the scale (K19).
  auto bias_term = [&](const bf16* t, int col) {
    if constexpr (P::kBiasRaw)
      return p.prescaled(__bfloat162float(t[col]));
    else if constexpr (P::kBiasAfterScale)
      return __bfloat162float(t[col]);
    else
      return __bfloat162float(t[WB - 1 - col]);
  };

  unsigned char* sK = smem_raw;
  unsigned char* sV = sK + L::kKV;
  float* sKs = reinterpret_cast<float*>(sV + L::kKV);                             // [NK] (I8)
  bf16* sPad = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sKs) + L::kScales);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  unsigned char* wbuf = reinterpret_cast<unsigned char*>(sPad) + L::kPad + warp * L::kWarp;
  bf16* sCodes = reinterpret_cast<bf16*>(wbuf + 2 * L::kBuf);  // [2][16][WB] (I8)

  const int inst = blockIdx.x;
  const int g = lane / 4, tq = lane % 4;
  const int Sq = p.Sq;
  const int n_tiles = (Sq + 15) / 16;
  const bf16* valid = p.q_row(inst, 0);

  // Q rows and raw bias rows of tile rt into buffer b, one cp.async group
  // (empty past the last tile); rows past Sq read as zero.
  auto prefetch = [&](int rt, int b) {
    if (rt < n_tiles) {
      unsigned char* dq = wbuf + b * L::kBuf;
      const int s0 = rt * 16;
      for (int i = lane; i < 16 * CPR; i += 32) {
        const int r = i / CPR, c = i % CPR;
        const bool live = s0 + r < Sq;
        cp_async16(dq + r * RB + c * 16, live ? p.q_row(inst, s0 + r) + c * 8 : valid, live);
      }
      bf16* db = reinterpret_cast<bf16*>(dq + 16 * RB);
      for (int i = lane; i < 2 * 16 * BW; i += 32) {
        const int term = i / (16 * BW), r = i / BW % 16, w = i % BW;
        const bool live = s0 + r < Sq;
        cp_async4(db + (term * 16 + r) * WB + 2 * w,
                  live ? p.bias_row(inst, s0 + r, term) + 2 * w : valid, live);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  prefetch(warp, 0);
  // K (with the pad tables), then V: the T real rows once; zero rows to NK.
  for (int part = 0; part < 2; ++part) {
    unsigned char* dst = part ? sV : sK;
    for (int i = tid; i < NK * CPR; i += kWwThreads) {
      const int r = i / CPR, c = i % CPR;
      const bf16* src = r < T ? (part ? p.v_row(inst, r) : p.k_row(inst, r)) : nullptr;
      cp_async16(dst + ww_offset<HD>(r, c), src != nullptr ? src + c * 8 : valid, src != nullptr);
    }
    if constexpr (P::kPadKeys) {
      if (part == 0 && tid < 2 * CPR) {
        const bf16* src = tid < CPR ? p.pad_k_row(inst) : p.pad_v_row(inst);
        cp_async16(sPad + tid * 8, src + (tid % CPR) * 8, true);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const float sl2 = p.scale * kLog2e;  // scores in base-2 units

  for (int it = 0, rt = warp; rt < n_tiles; ++it, rt += kWwWarps) {
    const int b = it & 1;
    const int s0 = rt * 16;
    const int row0 = s0 + g, row1 = row0 + 8;
    if (it == 0) {  // this tile's rows, K and the pad tables have landed
      cp_async_wait<1>();
      __syncthreads();
      if constexpr (I8) {  // K's codes in place, once for the block
        for (int i = tid; i < NK * 2; i += kWwThreads) {
          const int r = i >> 1, hf = i & 1;
          const float ks = ww_quantize_half_row<HD>(sK + r * RB, hf,
                                                    ww_swizzled<HD>() ? (r & 7) : 0);
          if (hf == 0) sKs[r] = ks;
        }
        __syncthreads();
      }
    } else {
      cp_async_wait<0>();
      __syncwarp();
    }
    prefetch(rt + kWwWarps, b ^ 1);
    unsigned char* sQ = wbuf + b * L::kBuf;
    const bf16* sRaw = reinterpret_cast<const bf16*>(sQ + 16 * RB);  // [2][16][WB] as stored

    // q . pad_k of rows row0, row1 from the bf16 q: a quarter of the lanes
    // a thread, summed over the quad.
    float qpk[2] = {0.f, 0.f};
    if constexpr (P::kPadKeys) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const __nv_bfloat162* qr =
            reinterpret_cast<const __nv_bfloat162*>(sQ + (g + 8 * r) * RB) + tq * (HD / 8);
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(sPad) + tq * (HD / 8);
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          const float2 a = __bfloat1622float2(qr[d]), k = __bfloat1622float2(kr[d]);
          acc = fmaf(a.x, k.x, acc);
          acc = fmaf(a.y, k.y, acc);
        }
        qpk[r] = quad_sum(acc);
      }
    }

    // Q fragments (I8: the rows' codes, quantized in place first) and the
    // bias terms: raw pre-scaled bf16, or (I8) each row's [A | B] codes.
    uint32_t qf[I8 ? 1 : KD][4];
    uint32_t qf8[I8 ? KD8 : 1][4];
    float qs[2] = {0.f, 0.f}, abss[2] = {0.f, 0.f};
    const bf16* tab = sRaw;
    if constexpr (I8) {
      const int r = lane >> 1, hf = lane & 1;
      const float sc = ww_quantize_half_row<HD>(sQ + r * RB, hf);
      qs[0] = __shfl_sync(0xffffffffu, sc, 2 * g);
      qs[1] = __shfl_sync(0xffffffffu, sc, 2 * g + 16);
      // [A | B] of row r: half hf is term hf's WB values.
      const bf16* src = sRaw + (hf * 16 + r) * WB;
      float amax = 0.f;
#pragma unroll
      for (int j = 0; j < WB; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(src[j])));
      amax = ww_row_amax(amax);
      const float inv = __fdiv_rn(127.f, amax);
#pragma unroll
      for (int j = 0; j < WB; ++j)
        sCodes[(hf * 16 + r) * WB + j] = __float2bfloat16(
            static_cast<float>(__float2int_rn(__fmul_rn(__bfloat162float(src[j]), inv))));
      const float ab = __fmul_rn(amax, 1.f / 127.f);
      abss[0] = __shfl_sync(0xffffffffu, ab, 2 * g);
      abss[1] = __shfl_sync(0xffffffffu, ab, 2 * g + 16);
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < KD8; ++kk)
        ldmatrix_x4(qf8[kk], reinterpret_cast<const bf16*>(sQ + (lane & 15) * RB + kk * 32 +
                                                           (lane >> 4) * 16));
      tab = sCodes;
    } else {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldmatrix_x4(qf[kk], reinterpret_cast<const bf16*>(sQ + (lane & 15) * RB + kk * 32 +
                                                          (lane >> 4) * 16));
    }

    float s[2 * NC][4];
    if constexpr (I8) {
      int si[2 * NC][4];
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll
      for (int kk = 0; kk < KD8; ++kk) {
#pragma unroll
        for (int np = 0; np < NC; ++np) {  // 16 keys: two m16n8k32 products
          uint32_t bq[4];
          const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bq, reinterpret_cast<const bf16*>(
                              sK + ww_offset<HD>(r, 2 * kk + ((lane >> 3) & 1))));
          mma_s8(si[2 * np], qf8[kk], bq[0], bq[1]);
          mma_s8(si[2 * np + 1], qf8[kk], bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j) {
#ifdef ULLAVA_MUTANT_I8_TILE_SCALE
        const float2 ks = make_float2(sKs[16 * (j / 2)], sKs[16 * (j / 2)]);
#else
        const float2 ks = *reinterpret_cast<const float2*>(sKs + 8 * j + 2 * tq);
#endif
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = __fmul_rn(static_cast<float>(si[j][e]),
                              __fmul_rn(qs[e >> 1], (e & 1) ? ks.y : ks.x));
      }
    } else {
      ww_qk_bf16<HD, NC>(s, qf, sK, lane);
    }

    // Bias, scale, key mask and four partial row maxima a row (exact: short
    // dependency chains) over a rectangle of C columns: key t = 8 j + c (c =
    // c0 + e % 2) has A's index t / C = qj + (rj + c >= C), with 8 j = C qj
    // + rj known at compile time, and B's index t % C, which repeats with j
    // % kPer. So a thread keeps its two rows' A terms and the kPer x 2 B
    // terms its keys meet in registers, read once a tile from the staged
    // rows; `c0` is an opaque copy of 2 tq taken in each tile, so that the
    // compiler recomputes their indices there rather than holding them
    // across tiles. A score is summed in the plain versions' order, (s + A
    // + B) * scale (K3, K14, K21; I8: s + (ca + cb) * abss) or s * scale + A
    // + B (K19), in base-2 units: folding the scale into the terms (one fma
    // a score) moved the int8 forms' errors over their gate.
    int c0;
    asm volatile("mov.b32 %0, %1;\n" : "=r"(c0) : "r"(2 * tq));
    float at[2][R + 1], bt[2][kPer][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bf16* ta = tab + (g + 8 * r) * WB;
      const bf16* tb = tab + (16 + g + 8 * r) * WB;
#pragma unroll
      for (int a = 0; a < R; ++a) at[r][a] = bias_term(ta, a);
      at[r][R] = 0.f;  // the index of a masked key past the last row
#pragma unroll
      for (int jj = 0; jj < kPer; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) bt[r][jj][e] = bias_term(tb, (8 * jj + c0 + e) % C);
      }
    }
    float mx[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[i / 4][i % 4] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = c0 + (e & 1);
        float x = -INFINITY;  // the keys past T
        if (8 * j < T) {
          const int qj = (8 * j) / C, rj = (8 * j) % C;
          const float bias = (rj + c >= C ? at[r][qj + 1] : at[r][qj]) + bt[r][j % kPer][e & 1];
          if constexpr (I8) {
            x = __fadd_rn(s[j][e], __fmul_rn(bias, abss[r])) * sl2;  // bias: ca + cb, exact
          } else if constexpr (P::kBiasAfterScale) {
#ifdef ULLAVA_MUTANT_PACKED_BIAS_PRESCALED
            x = (s[j][e] + bias) * sl2;  // the bias read as if pre-scaled by 1/scale
#else
            x = s[j][e] * sl2 + bias * kLog2e;
#endif
          } else {
            x = (s[j][e] + bias) * sl2;
          }
          if (8 * j + 7 >= T && 8 * j + c >= T) x = -INFINITY;
        }
        s[j][e] = x;
        mx[r][(j % 2) * 2 + (e & 1)] = fmaxf(mx[r][(j % 2) * 2 + (e & 1)], x);
      }
    }

    // K14's pad positions: rows a in [R, WB) by every column, then rows
    // a < R by columns [C, WB); thread tq takes a = tq mod 4 of each part.
    // `pad_pass(f)` calls f(row, score) on each of this thread's pads.
    auto pad_pass = [&](auto f) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bf16* ta = sRaw + (g + 8 * r) * WB;
        const bf16* tb = sRaw + (16 + g + 8 * r) * WB;
        float bv[WB];
#pragma unroll
        for (int bb = 0; bb < WB; ++bb) bv[bb] = __bfloat162float(tb[WB - 1 - bb]);
        for (int a = R + tq; a < WB; a += 4) {
          const float base = qpk[r] + __bfloat162float(ta[WB - 1 - a]);
#pragma unroll
          for (int bb = 0; bb < WB; ++bb) f(r, (base + bv[bb]) * sl2);
        }
        for (int a = tq; a < R; a += 4) {
          const float base = qpk[r] + __bfloat162float(ta[WB - 1 - a]);
#pragma unroll
          for (int bb = C; bb < WB; ++bb) f(r, (base + bv[bb]) * sl2);
        }
      }
    };
    if constexpr (P::kPadKeys) pad_pass([&](int r, float x) { mx[r][0] = fmaxf(mx[r][0], x); });

    float m[2], l[2], sum[2], pad[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mt = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
#ifdef ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX
      m[r] = mt;
#else
      m[r] = quad_max(mt);
#endif
      sum[r] = 0.f;  // exp2(s - m) replaces s
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = kHd64 ? ww_exp2(s[j][e] - m[r]) : exp2f(s[j][e] - m[r]);
          sum[r] += s[j][e];
        }
      }
    }
    if constexpr (P::kPadKeys) pad_pass([&](int r, float x) { pad[r] += exp2f(x - m[r]); });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (P::kPadKeys) {
#ifdef ULLAVA_MUTANT_RECT_PAD_OUT_OF_SUM
        l[r] = quad_sum(sum[r]);
#else
        l[r] = quad_sum(sum[r] + pad[r]);
#endif
        pad[r] = __fdiv_rn(quad_sum(pad[r]), l[r]);  // the pad mass
      } else {
        l[r] = quad_sum(sum[r]);
      }
    }
    uint32_t pa[NC][4];
    ww_probs<NC, kHd64>(s, l, pa);
    if (it == 0) {  // V has landed
      cp_async_wait<1>();
      __syncthreads();
    }

    float o[ND][4];
    ww_pv<HD, NC, T>(o, pa, sV, lane);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = n * 8 + tq * 2;
      if constexpr (P::kPadKeys) {  // + pad_mass * pad_v, in fp32
        const float2 v =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sPad + HD + d));
        o[n][0] = fmaf(pad[0], v.x, o[n][0]);
        o[n][1] = fmaf(pad[0], v.y, o[n][1]);
        o[n][2] = fmaf(pad[1], v.x, o[n][2]);
        o[n][3] = fmaf(pad[1], v.y, o[n][3]);
      }
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row0) + d) =
            __floats2bfloat162_rn(o[n][0], o[n][1]);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row1) + d) =
            __floats2bfloat162_rn(o[n][2], o[n][3]);
    }
#ifdef ULLAVA_MUTANT_PACKED_PAD_LANES_UNWRITTEN
    constexpr bool kZeroPad = false;  // the pad lanes left as they were
#else
    constexpr bool kZeroPad = kOutPad > 0;
#endif
    if constexpr (kZeroPad) {  // the output's pad lanes (K19): zeros, 16 bytes a store
      constexpr int PC = kOutPad / 8;
      for (int i = lane; i < 16 * PC; i += 32) {
        const int r = i / PC, c = i % PC;
        if (s0 + r < Sq)
          *reinterpret_cast<uint4*>(p.o_row(inst, s0 + r) + HD + c * 8) = make_uint4(0, 0, 0, 0);
      }
    }
    __syncwarp();  // buffer b is refilled at tile it + 1
  }
}

template <int HD, int WB, class P, class G0, class G1, bool I8>
__global__ void __launch_bounds__(kWwThreads, ww_min_blocks<G0>())
    window_whole_kernel(const P p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  static_assert(G0::NC == G1::NC, "both geometries of a launch share its layout");
  if constexpr (std::is_same<G0, G1>::value) {
    ww_window_body<HD, WB, P, G0, I8>(p, smem_raw);
  } else {  // a dual-geometry launch: windows [0, n_first) take G0
    if (static_cast<int>(blockIdx.x) / p.H < p.n_first)
      ww_window_body<HD, WB, P, G0, I8>(p, smem_raw);
    else
      ww_window_body<HD, WB, P, G1, I8>(p, smem_raw);
  }
}

// K14 at hd 64 (ViT-L's and ViT-B's boundary windows, both score forms):
// the B=1 schedule of the header's note. The smem layout: K and V (NK
// rows each), the int8 K scales, the pad tables, then per warp its 16 Q
// rows, its 2 x 16 raw bias rows and (I8) their codes.
template <int HD, int WB, class G, bool I8>
struct RsLayout {
  static constexpr int RB = ww_row_bytes<HD>();
  static constexpr int NK = G::NC * 16;
  static constexpr int kKV = NK * RB;
  static constexpr int kScales = I8 ? NK * 4 : 0;
  static constexpr int kPad = 2 * HD * 2;
  static constexpr int kBias = 2 * 16 * WB * 2;
  static constexpr int kWarp = 16 * RB + kBias * (I8 ? 2 : 1);
  static constexpr int kBytes = 2 * kKV + kScales + kPad + kWarp * G::NC;
  static_assert(kBias % 16 == 0 && kScales % 16 == 0 && kPad % 16 == 0, "16-byte sections");
};

// One block per (window, head), one warp per 16-row query tile (G::NC of
// them: 7 for the edges' 112 rows, 4 for the corner's 64).
template <int HD, int WB, class P, class G, bool I8>
__device__ __forceinline__ void rect_split_body(const P& p, unsigned char* smem_raw) {
  using L = RsLayout<HD, WB, G, I8>;
  constexpr int R = G::R, C = G::C, T = G::T, NC = G::NC, NK = L::NK, RB = L::RB;
  constexpr int NW = NC, NT = NW * 32;
  constexpr int KD = HD / 16;          // k-steps of the bf16 Q K^T
  constexpr int KD8 = (HD + 31) / 32;  // k-steps of the int8 Q K^T
  constexpr int ND = HD / 8;           // 8-wide column tiles of O
  constexpr int CPR = HD / 8;          // 16-byte chunks of a row
  constexpr int kPer = C / gcd_int(8, C);
  constexpr int BW = WB / 2;
  static_assert(P::kPadKeys && !P::kBiasRaw && ww_swizzled<HD>(), "K14's swizzled form");
  static_assert(C >= 8 && C <= WB && R <= WB && WB <= 16, "a key's A index moves at most one row in 8 keys");
  static_assert(!I8 || KD8 * 32 <= RB, "an int8 row fits in its bf16 row");
  constexpr float kLog2e = 1.4426950408889634f;

  unsigned char* sK = smem_raw;
  unsigned char* sV = sK + L::kKV;
  float* sKs = reinterpret_cast<float*>(sV + L::kKV);  // [NK] (I8)
  bf16* sPad = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(sKs) + L::kScales);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  unsigned char* sQ = reinterpret_cast<unsigned char*>(sPad) + L::kPad + warp * L::kWarp;
  const bf16* sRaw = reinterpret_cast<const bf16*>(sQ + 16 * RB);  // [2][16][WB] as stored
  bf16* sCodes = reinterpret_cast<bf16*>(sQ + 16 * RB + L::kBias);  // [2][16][WB] (I8)

  const int inst = blockIdx.x;
  const int g = lane / 4, tq = lane % 4;
  const int Sq = p.Sq;
  const int s0 = warp * 16;
#ifdef ULLAVA_MUTANT_RECT_TILE_BIAS_ROWS
  const int sb = ((warp + 1) % NW) * 16;  // the next warp's tile's bias rows
#else
  const int sb = s0;
#endif
  const int row0 = s0 + g, row1 = row0 + 8;
  const bf16* valid = p.q_row(inst, 0);

  // Group 0: this warp's Q rows and raw bias rows, the block's K (T real
  // rows, zero rows to NK) and the pad tables; group 1: V.
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    const bool live = s0 + r < Sq;
    cp_async16(sQ + r * RB + c * 16, live ? p.q_row(inst, s0 + r) + c * 8 : valid, live);
  }
  for (int i = lane; i < 2 * 16 * BW; i += 32) {
    const int term = i / (16 * BW), r = i / BW % 16, w = i % BW;
    const bool live = sb + r < Sq;
    cp_async4(const_cast<bf16*>(sRaw) + (term * 16 + r) * WB + 2 * w,
              live ? p.bias_row(inst, sb + r, term) + 2 * w : valid, live);
  }
  for (int part = 0; part < 2; ++part) {
    unsigned char* dst = part ? sV : sK;
    for (int i = tid; i < NK * CPR; i += NT) {
      const int r = i / CPR, c = i % CPR;
      const bf16* src = r < T ? (part ? p.v_row(inst, r) : p.k_row(inst, r)) : nullptr;
      cp_async16(dst + ww_offset<HD>(r, c), src != nullptr ? src + c * 8 : valid, src != nullptr);
    }
    if (part == 0 && tid < 2 * CPR) {
      const bf16* src = tid < CPR ? p.pad_k_row(inst) : p.pad_v_row(inst);
      cp_async16(sPad + tid * 8, src + (tid % CPR) * 8, true);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const float sl2 = p.scale * kLog2e;  // scores in base-2 units

  cp_async_wait<1>();
  __syncthreads();
  if constexpr (I8) {  // K's codes in place, one half row a thread
    for (int i = tid; i < NK * 2; i += NT) {
      const int r = i >> 1, hf = i & 1;
      const float ks = ww_quantize_half_row<HD>(sK + r * RB, hf, r & 7);
      if (hf == 0) sKs[r] = ks;
    }
  }

  // q . pad_k of rows row0, row1 from the bf16 q (before Q's codes replace it).
  float qpk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const __nv_bfloat162* qr =
        reinterpret_cast<const __nv_bfloat162*>(sQ + (g + 8 * r) * RB) + tq * (HD / 8);
    const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(sPad) + tq * (HD / 8);
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const float2 a = __bfloat1622float2(qr[d]), k = __bfloat1622float2(kr[d]);
      acc = fmaf(a.x, k.x, acc);
      acc = fmaf(a.y, k.y, acc);
    }
    qpk[r] = quad_sum(acc);
  }

  // Q fragments (I8: the rows' codes, quantized in place first) and the
  // bias terms: raw pre-scaled bf16, or (I8) each row's [A | B] codes.
  uint32_t qf[I8 ? 1 : KD][4];
  uint32_t qf8[I8 ? KD8 : 1][4];
  float qs[2] = {0.f, 0.f}, abss[2] = {0.f, 0.f};
  const bf16* tab = sRaw;
  if constexpr (I8) {
    const int r = lane >> 1, hf = lane & 1;
    const float sc = ww_quantize_half_row<HD>(sQ + r * RB, hf);
    qs[0] = __shfl_sync(0xffffffffu, sc, 2 * g);
    qs[1] = __shfl_sync(0xffffffffu, sc, 2 * g + 16);
    const bf16* src = sRaw + (hf * 16 + r) * WB;
    float v[WB];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < WB; ++j) {
      v[j] = __bfloat162float(src[j]);
      amax = fmaxf(amax, fabsf(v[j]));
    }
    amax = ww_row_amax(amax);
    const float inv = __fdiv_rn(127.f, amax);
#pragma unroll
    for (int j = 0; j < WB; ++j)
      sCodes[(hf * 16 + r) * WB + j] =
          __float2bfloat16(static_cast<float>(__float2int_rn(__fmul_rn(v[j], inv))));
    const float ab = __fmul_rn(amax, 1.f / 127.f);
    abss[0] = __shfl_sync(0xffffffffu, ab, 2 * g);
    abss[1] = __shfl_sync(0xffffffffu, ab, 2 * g + 16);
    __syncthreads();  // K's codes and this warp's Q codes are written
#pragma unroll
    for (int kk = 0; kk < KD8; ++kk)
      ldmatrix_x4(qf8[kk], reinterpret_cast<const bf16*>(sQ + (lane & 15) * RB + kk * 32 +
                                                         (lane >> 4) * 16));
    tab = sCodes;
  } else {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk], reinterpret_cast<const bf16*>(sQ + (lane & 15) * RB + kk * 32 +
                                                        (lane >> 4) * 16));
  }

  float s[2 * NC][4];
  if constexpr (I8) {
    int si[2 * NC][4];
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < KD8; ++kk) {
#pragma unroll
      for (int np = 0; np < NC; ++np) {
        uint32_t bq[4];
        const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bq, reinterpret_cast<const bf16*>(
                            sK + ww_offset<HD>(r, 2 * kk + ((lane >> 3) & 1))));
        mma_s8(si[2 * np], qf8[kk], bq[0], bq[1]);
        mma_s8(si[2 * np + 1], qf8[kk], bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
#ifdef ULLAVA_MUTANT_I8_TILE_SCALE
      const float2 ks = make_float2(sKs[16 * (j / 2)], sKs[16 * (j / 2)]);
#else
      const float2 ks = *reinterpret_cast<const float2*>(sKs + 8 * j + 2 * tq);
#endif
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = __fmul_rn(static_cast<float>(si[j][e]),
                            __fmul_rn(qs[e >> 1], (e & 1) ? ks.y : ks.x));
    }
  } else {
    ww_qk_bf16<HD, NC>(s, qf, sK, lane);
  }

  // Bias, scale, key mask and each thread's partial row max (as the whole
  // window core's body).
  int c0;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(c0) : "r"(2 * tq));
  float mx[2][4];
  {
    float at[2][R + 1], bt[2][kPer][2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bf16* ta = tab + (g + 8 * r) * WB;
      const bf16* tb = tab + (16 + g + 8 * r) * WB;
#pragma unroll
      for (int a = 0; a < R; ++a) at[r][a] = __bfloat162float(ta[WB - 1 - a]);
      at[r][R] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kPer; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e) bt[r][jj][e] = __bfloat162float(tb[WB - 1 - (8 * jj + c0 + e) % C]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[i / 4][i % 4] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int c = c0 + (e & 1);
        float x = -INFINITY;
        if (8 * j < T) {
          const int qj = (8 * j) / C, rj = (8 * j) % C;
          const float bias = (rj + c >= C ? at[r][qj + 1] : at[r][qj]) + bt[r][j % kPer][e & 1];
          if constexpr (I8)
            x = __fadd_rn(s[j][e], __fmul_rn(bias, abss[r])) * sl2;
          else
            x = (s[j][e] + bias) * sl2;
          if (8 * j + 7 >= T && 8 * j + c >= T) x = -INFINITY;
        }
        s[j][e] = x;
        mx[r][(j % 2) * 2 + (e & 1)] = fmaxf(mx[r][(j % 2) * 2 + (e & 1)], x);
      }
    }
  }

  // The pad positions, summed in closed form. Pad (a, b) scores (q . pad_k
  // + A[a] + B[b]) * scale over two rectangles: rows a in [R, WB) by every
  // column (region 1), rows a < R by columns [C, WB) (region 2). Region k's
  // largest score is (q . pad_k + max A + max B) * scale over its rows and
  // columns (exactly: rounding is monotonic), and its sum of exp2(x - m)
  // is exp2(max_k - m) * sum_a exp2((A[a] - max A) sl2) * sum_b exp2((B[b]
  // - max B) sl2): 28 terms a row in place of its 84 to 132 pads. A thread
  // takes a, b = tq + 4 i; the quad reduces.
  float pmax[2][2], psum[2][2];  // [row][region]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bf16* ta = sRaw + (g + 8 * r) * WB;
    const bf16* tb = sRaw + (16 + g + 8 * r) * WB;
    float av[4], bv[4];
    float a1 = -INFINITY, a2 = -INFINITY, b1 = -INFINITY, b2 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = tq + 4 * i;
      av[i] = k < WB ? __bfloat162float(ta[WB - 1 - k]) : -INFINITY;
      bv[i] = k < WB ? __bfloat162float(tb[WB - 1 - k]) : -INFINITY;
      if (k >= R) a1 = fmaxf(a1, av[i]); else a2 = fmaxf(a2, av[i]);
      b1 = fmaxf(b1, bv[i]);
      if (k >= C) b2 = fmaxf(b2, bv[i]);
    }
    a1 = quad_max(a1);
    a2 = quad_max(a2);
    b1 = quad_max(b1);
    b2 = quad_max(b2);
    pmax[r][0] = R < WB ? (qpk[r] + a1 + b1) * sl2 : -INFINITY;
    pmax[r][1] = C < WB ? (qpk[r] + a2 + b2) * sl2 : -INFINITY;
    float ea1 = 0.f, ea2 = 0.f, eb1 = 0.f, eb2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = tq + 4 * i;
      if (k < WB) {
        if (k >= R)
          ea1 += exp2f((av[i] - a1) * sl2);
        else
          ea2 += exp2f((av[i] - a2) * sl2);
        eb1 += exp2f((bv[i] - b1) * sl2);
        if (k >= C) eb2 += exp2f((bv[i] - b2) * sl2);
      }
    }
#ifdef ULLAVA_MUTANT_RECT_PAD_SUM_NO_QUAD
    // each thread's own sums
#else
    ea1 = quad_sum(ea1);
    ea2 = quad_sum(ea2);
    eb1 = quad_sum(eb1);
    eb2 = quad_sum(eb2);
#endif
    psum[r][0] = ea1 * eb1;
    psum[r][1] = ea2 * eb2;
  }

  float m[2], l[2], pad[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mt = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
#ifdef ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX
    m[r] = fmaxf(mt, fmaxf(pmax[r][0], pmax[r][1]));
#else
    m[r] = fmaxf(quad_max(mt), fmaxf(pmax[r][0], pmax[r][1]));
#endif
    float sum = 0.f;  // exp2(s - m) replaces s
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[j][e] = exp2f(s[j][e] - m[r]);
        sum += s[j][e];
      }
    }
    const float ps = exp2f(pmax[r][0] - m[r]) * psum[r][0] + exp2f(pmax[r][1] - m[r]) * psum[r][1];
#ifdef ULLAVA_MUTANT_RECT_PAD_OUT_OF_SUM
    l[r] = quad_sum(sum);
#else
    l[r] = quad_sum(sum) + ps;
#endif
    pad[r] = __fdiv_rn(ps, l[r]);  // the pad mass
  }
  uint32_t pa[NC][4];
  ww_probs<NC, false>(s, l, pa);
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  float o[ND][4];
  ww_pv<HD, NC, T>(o, pa, sV, lane);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + tq * 2;
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sPad + HD + d));
    o[n][0] = fmaf(pad[0], v.x, o[n][0]);
    o[n][1] = fmaf(pad[0], v.y, o[n][1]);
    o[n][2] = fmaf(pad[1], v.x, o[n][2]);
    o[n][3] = fmaf(pad[1], v.y, o[n][3]);
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row0) + d) =
          __floats2bfloat162_rn(o[n][0], o[n][1]);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row1) + d) =
          __floats2bfloat162_rn(o[n][2], o[n][3]);
  }
}

// Two blocks an SM: the register limit that sets (the `dots_i8` edges
// spill 8 bytes a thread) ran faster than one block an SM at 159 registers.
template <int HD, int WB, class P, class G0, class G1, bool I8>
__global__ void __launch_bounds__(G0::NC * 32, 2) rect_split_kernel(const P p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  static_assert(G0::NC == G1::NC, "both geometries of a launch share its layout");
  if constexpr (std::is_same<G0, G1>::value) {
    rect_split_body<HD, WB, P, G0, I8>(p, smem_raw);
  } else {  // a dual-geometry launch: windows [0, n_first) take G0
    if (static_cast<int>(blockIdx.x) / p.H < p.n_first)
      rect_split_body<HD, WB, P, G0, I8>(p, smem_raw);
    else
      rect_split_body<HD, WB, P, G1, I8>(p, smem_raw);
  }
}

template <int HD, int WB, class P, class G0, class G1, bool I8>
int rect_split_configure() {
  constexpr int smem = RsLayout<HD, WB, G0, I8>::kBytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(rect_split_kernel<HD, WB, P, G0, G1, I8>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

// Launches one block of G0::NC warps per (window, head) on `stream`; Sq
// must be the rectangle's T.
template <int HD, int WB, class P, class G0, class G1, bool I8>
int launch_rect_split(const P& p, int num_inst, cudaStream_t stream) {
  if (const int err = rect_split_configure<HD, WB, P, G0, G1, I8>()) return err;
  if (G1::T != G0::T || p.Sq != G0::T) return static_cast<int>(cudaErrorInvalidValue);
  if (num_inst == 0) return 0;
  rect_split_kernel<HD, WB, P, G0, G1, I8>
      <<<num_inst, G0::NC * 32, RsLayout<HD, WB, G0, I8>::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int WB, class P, class G0, class G1, bool I8>
int rect_split_attrs(int* out) {
  if (const int err = rect_split_configure<HD, WB, P, G0, G1, I8>()) return err;
  return func_attrs(rect_split_kernel<HD, WB, P, G0, G1, I8>, G0::NC * 32,
                    RsLayout<HD, WB, G0, I8>::kBytes, out);
}

// Sets the kernel's shared-memory attributes once (per instantiation).
template <int HD, int WB, class P, class G0, class G1, bool I8>
int window_whole_configure() {
  constexpr int smem = WwLayout<HD, WB, P, G0, I8>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(window_whole_kernel<HD, WB, P, G0, G1, I8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_whole_kernel<HD, WB, P, G0, G1, I8>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

// Launches one block of kWwWarps warps per instance on `stream`. K3 (whole
// windows) takes Sq rows from T to the NK the layout holds; K14
// (kPadKeys) and K19 (kBiasAfterScale) exactly their T rows.
template <int HD, int WB, class P, class G0 = WwRect<WB, WB>, class G1 = G0, bool I8 = false>
int launch_window_whole(const P& p, int num_inst, cudaStream_t stream) {
  if (const int err = window_whole_configure<HD, WB, P, G0, G1, I8>()) return err;
  constexpr int T = G0::T;
  if (G1::T != T || (P::kPadKeys || P::kBiasAfterScale ? p.Sq != T
                                                       : p.Sq < T || p.Sq > G0::NC * 16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (num_inst == 0 || p.Sq == 0) return 0;
  window_whole_kernel<HD, WB, P, G0, G1, I8>
      <<<num_inst, kWwThreads, WwLayout<HD, WB, P, G0, I8>::kBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// {registers a thread, shared bytes a block (dynamic + static), local
// (spilled) bytes a thread, blocks an SM} of one instantiation, from
// cudaFuncGetAttributes and the occupancy calculator.
template <int HD, int WB, class P, class G0 = WwRect<WB, WB>, class G1 = G0, bool I8 = false>
int window_whole_attrs(int* out) {
  if (const int err = window_whole_configure<HD, WB, P, G0, G1, I8>()) return err;
  return func_attrs(window_whole_kernel<HD, WB, P, G0, G1, I8>, kWwThreads,
                    WwLayout<HD, WB, P, G0, I8>::kBytes, out);
}

}  // namespace ullava
