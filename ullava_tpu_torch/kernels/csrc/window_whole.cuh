// Whole-window attention: one block per (window, head) owns all the
// window's query rows, and each warp keeps the whole key row of its scores
// in registers, so the softmax normalises P before rounding it to bf16
// exactly where the TPU kernels do (p = exp(s - m) / sum(p), p.astype(bf16),
// P V summed in fp32 with no final division) with no scores parked in
// shared memory and no second pass over the keys. Three kernels run on it:
//   - K19, the packed window kernel (`_packed_window_kernel`,
//     ullava_tpu/ops/sam_attention.py:791-822): HD 128, the raw bias terms
//     added after the scale (P::kBiasAfterScale);
//   - K3, the grid window kernel (`_grid_kernel` :113-178): HD 80 (ViT-H;
//     and HD 64, ViT-L's and ViT-B's head, in bf16), bias terms pre-scaled
//     by 1/scale and added before it, a window stored as Sq = 196 or
//     `total_rows` = 200 rows of which the first 196 are keys;
//   - K14, the boundary-window kernel (`_rect_kernel` :261-350): HD 80
//     (and HD 64 in bf16), only the T = R x C real tokens of a logical
//     WB x WB window are rows and keys (the geometry G, a template
//     parameter); the pad positions
//     are not keys of any product (P::kPadKeys, below);
//   - K21, the per-(window, head) window kernel (`_kernel` :29-67): K3's
//     function on head-major [N, 196, 80] q, k and v, its bias terms raw
//     in natural column order (P::kBiasRaw): each term is scaled by
//     1/scale and rounded to bf16 where a thread reads it, as the TPU
//     wrapper pre-scales them (:88-90).
// K3 and K14 also take the int8 score form (I8, `dots_i8`).
//
// Design (windows of at most kWwKeys = 208 keys: 196 for 14 x 14, padded
// to 13 chunks of 16):
//   - K and V of the instance are copied into shared memory once, with
//     16-byte cp.async copies, K and V in two groups so that Q K^T starts
//     while V lands; rows past the keys are zero-filled. At HD 128 (and HD
//     64) rows are 256 (128) bytes with the 16-byte chunks XOR-swizzled by
//     the row's low three bits; at HD 80 (10 chunks, for which that XOR is
//     no permutation) rows are padded to 176 bytes, 11 chunks, so 8
//     consecutive rows start in 8
//     distinct 16-byte bank groups. Either way the ldmatrix reads of 8 rows
//     hit 32 distinct banks. K19: 104 KB plus a 896-byte bias table a warp,
//     two blocks an SM.
//   - The window's rows form tiles of 16 (13 for 196-208 rows, the last
//     partly live) over kWwWarps = 4 warps: warp w takes tiles w, w + 4, ...
//     Four warps give each thread 255 registers at HD 128, which the score
//     row (104 fp32 a thread: 26 accumulator tiles of mma.sync.m16n8k16)
//     and Q's fragments (32) need; eight would leave 128 and spill. At HD
//     80 a thread holds 20 Q and 40 O registers instead of 32 and 64, at
//     HD 64 16 and 32 (chip_smoke.py reads each instance's registers,
//     spills and blocks an SM with cudaFuncGetAttributes). Each
//     warp runs S = Q K^T, adds the bias terms, scales, masks the pad keys,
//     takes the row max and sum over its quad (two shuffles each), and
//     rounds p = exp(s - m) / l to bf16 straight into the A fragments of
//     O = P V. O goes out as bf16 with no final division.
//   - The bias terms A[s][a] and B[s][b] of key (a, b) (t / C, t % C for
//     compact key t of a rectangle of C columns) are read by each thread
//     into registers once a tile: its rows' A terms (key t's by a
//     compile-time index and a select) and the kPer x 2 B terms that
//     t % C cycles through. K19 stages its tile's terms with plain loads;
//     K3 and K14 prefetch the next tile's Q rows and raw bias rows into a
//     second per-warp buffer with cp.async while the tile is computed.
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
//     int8 codes (hd zero-padded to 96 bytes: three k-steps of
//     mma.sync.m16n8k32) with each row's scale beside them; each warp
//     quantizes its tile's Q rows (in place) and [A | B] rows. Codes and
//     scales are `_row_quant`'s bit for bit: abs-max floored at 1e-12,
//     127 / amax as an IEEE division, round half to even, scale amax *
//     (1 / 127). s = (float(qk) * (qs * ks) + float(ca + cb) * abss) *
//     scale; K14's pads keep the unquantized score; P V stays bf16.
//
// Compiled with ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX each thread normalises its
// scores by its own partial row max instead of the quad's; with
// ULLAVA_MUTANT_I8_TILE_SCALE the int8 forms dequantize every key of a
// 16-key chunk with the chunk's first key's scale; with
// ULLAVA_MUTANT_RECT_PAD_OUT_OF_SUM K14's pad scores enter the row max but
// not the row sum. Deliberate bugs that only `chip_smoke.py` builds, to show
// that the gates catch them.
#pragma once

#include <type_traits>

#include "flash_core.cuh"

namespace ullava {

constexpr int kWwKeys = 208;  // keys a window can hold (13 chunks of 16)
constexpr int kWwWarps = 4;
constexpr int kWwThreads = kWwWarps * 32;
constexpr int kWwRowTiles = kWwKeys / 16;

// The real R x C rectangle of a logical window (R = C = WB: a whole one).
template <int R_, int C_>
struct WwRect {
  static constexpr int R = R_, C = C_, T = R_ * C_;
  static constexpr int NC = (T + 15) / 16;  // 16-key chunks
};

template <int HD, int WB>
constexpr size_t window_whole_smem_bytes() {
  return sizeof(bf16) * (2 * kWwKeys * HD + kWwWarps * 2 * 16 * WB);
}

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

// p = exp(s - m) / l rounded to bf16, as the A fragments of 16-key chunks.
// The quotient is the IEEE one, taken as q = a * (1 / l) and one
// correction q + (a - q l) / l with fma (Markstein: exact for a correctly
// rounded reciprocal and a normal quotient), three operations in place of
// the general division's subroutine.
template <int NC>
__device__ __forceinline__ void ww_probs(const float (&s)[2 * NC][4], const float (&l)[2],
                                         uint32_t (&pa)[NC][4]) {
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
        pv[h2][e] = __fmaf_rn(__fmaf_rn(-q, l[r], a), rl[r], q);
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
// [HD, 32 * ceil(HD / 32)) zero, and the row's scale is returned. A half is
// read whole before any code is written (the partner's codes land on this
// half only after the shuffle, which waits for these reads).
template <int HD>
__device__ __forceinline__ float ww_quantize_half_row(unsigned char* row, int hf) {
  constexpr int HALF = HD / 2, KB = (HD + 31) / 32 * 32;
  static_assert(HALF % 8 == 0, "half a row of whole 16-byte chunks");
  float v[HALF];
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < HALF / 8; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + hf * HALF * 2 + c * 16);
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
    *reinterpret_cast<uint32_t*>(row + hf * HALF + c) = w;
  }
  if (hf == 1) {
#pragma unroll
    for (int b = HD; b < KB; b += 4) *reinterpret_cast<uint32_t*>(row + b) = 0u;
  }
  return __fmul_rn(amax, 1.f / 127.f);
}

template <class G>
__host__ __device__ constexpr int ww_min_blocks() {
  return G::NC > 8 ? 2 : 3;
}

// The shared-memory layout of K3's and K14's blocks: K and V (NK rows
// each), the int8 K scales, the pad tables, then per warp two buffers of
// [16 Q rows | 2 x 16 raw bias rows of WB] and the bias codes (I8).
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

// K3's and K14's block over geometry G (see the header).
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
  static_assert(C >= 8 && C <= WB && R <= WB, "a key's A index moves at most one row in 8 keys");
  static_assert(WB % 2 == 0, "bias rows of whole 4-byte words");
  static_assert(NK <= kWwKeys && (T + 15) / 16 >= kWwWarps, "every warp has a tile");
  static_assert(!I8 || KD8 * 32 <= RB, "an int8 row fits in its bf16 row");
  static_assert(!P::kBiasRaw || (!I8 && !P::kPadKeys), "raw bias terms: K21's form only");
  constexpr float kLog2e = 1.4426950408889634f;
  // Bias term `col` of a staged row: reversed and pre-scaled (K3, K14), or
  // natural and raw, pre-scaled here (K21).
  auto bias_term = [&](const bf16* t, int col) {
    if constexpr (P::kBiasRaw)
      return p.prescaled(__bfloat162float(t[col]));
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
          const float ks = ww_quantize_half_row<HD>(sK + ww_offset<HD>(r, 0), hf);
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
          ldmatrix_x4(bq, reinterpret_cast<const bf16*>(sK + r * RB + kk * 32 +
                                                        ((lane >> 3) & 1) * 16));
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

    // Bias, scale, key mask, the row max over the quad, as K19 below but
    // over a rectangle of C columns: 8 j = C qj + rj at compile time, the
    // A index qj + (rj + c >= C), the B index (8 j + c) % C repeating with
    // j % kPer. K3's and K14's tables are in the TPU's reversed column
    // order, K21's in natural order.
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
          if constexpr (I8)
            x = __fadd_rn(s[j][e], __fmul_rn(bias, abss[r])) * sl2;  // bias: ca + cb, exact
          else
            x = (s[j][e] + bias) * sl2;
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
          s[j][e] = exp2f(s[j][e] - m[r]);
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
    ww_probs<NC>(s, l, pa);
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
    __syncwarp();  // buffer b is refilled at tile it + 1
  }
}

template <int HD, int WB, class P, class G0, class G1, bool I8>
__global__ void __launch_bounds__(kWwThreads, P::kBiasAfterScale ? 2 : ww_min_blocks<G0>())
    window_whole_kernel(const P p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  if constexpr (!P::kBiasAfterScale) {
    static_assert(G0::NC == G1::NC, "both geometries of a launch share its layout");
    if constexpr (std::is_same<G0, G1>::value) {
      ww_window_body<HD, WB, P, G0, I8>(p, smem_raw);
    } else {  // a dual-geometry launch: windows [0, n_first) take G0
      if (static_cast<int>(blockIdx.x) / p.H < p.n_first)
        ww_window_body<HD, WB, P, G0, I8>(p, smem_raw);
      else
        ww_window_body<HD, WB, P, G1, I8>(p, smem_raw);
    }
    return;
  } else {
    // K19: the packed form, whole windows of WB x WB, the bias added after
    // the scale. Q and the bias terms are read from global memory a tile.
    static_assert(WB > 0 && WB * WB <= kWwKeys, "a window of at most 208 keys");
    static_assert(!I8 && std::is_same<G0, WwRect<WB, WB>>::value, "the packed form: whole windows");
    constexpr int KD = HD / 16;     // k-steps of Q K^T
    constexpr int ND = HD / 8;      // 8-wide column tiles of O
    constexpr int NC = kWwKeys / 16;  // 16-key chunks of a score row
    constexpr int CPR = HD / 8;     // 16-byte chunks a row
    constexpr int kKeys = WB * WB;  // a whole window: every query row sees every key
    constexpr int kPer = WB / gcd_int(8, WB);  // (8 j) % WB repeats with j % kPer
    constexpr float kLog2e = 1.4426950408889634f;

    unsigned char* sK = smem_raw;                              // [kWwKeys][HD] bf16, swizzled
    unsigned char* sV = sK + kWwKeys * HD * 2;                 // [kWwKeys][HD] bf16, swizzled
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    bf16* sBA = reinterpret_cast<bf16*>(sV + kWwKeys * HD * 2) + warp * 2 * 16 * WB;  // [16][WB]
    bf16* sBB = sBA + 16 * WB;                                                       // [16][WB]

    const int inst = blockIdx.x;
    const int g = lane / 4, tq = lane % 4;  // row in the 8-row group, thread in quad
    constexpr int Sq = kKeys;  // query rows of a window

    // K, then V: every row of the instance once; zero rows past kKeys.
    const bf16* valid = p.q_row(inst, 0);
    for (int part = 0; part < 2; ++part) {
      unsigned char* dst = part ? sV : sK;
      for (int i = tid; i < kWwKeys * CPR; i += kWwThreads) {
        const int r = i / CPR, c = i % CPR;
        const bf16* src = r < kKeys ? (part ? p.v_row(inst, r) : p.k_row(inst, r)) : nullptr;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_addr(dst + ww_offset<HD>(r, c))),
                     "l"(src != nullptr ? src + c * 8 : valid), "r"(src != nullptr ? 16 : 0));
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    const float sl2 = p.scale * kLog2e;  // scores in base-2 units

    for (int it = 0, rt = warp; rt < kWwRowTiles; ++it, rt += kWwWarps) {
      const int s0 = rt * 16;
      const int row0 = s0 + g, row1 = row0 + 8;
      // Q fragments straight from global memory (rows past Sq read as 0).
      uint32_t qf[KD][4];
      {
        const uint32_t* q0p =
            reinterpret_cast<const uint32_t*>(p.q_row(inst, row0 < Sq ? row0 : 0) + 2 * tq);
        const uint32_t* q1p =
            reinterpret_cast<const uint32_t*>(p.q_row(inst, row1 < Sq ? row1 : 0) + 2 * tq);
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          qf[kk][0] = row0 < Sq ? q0p[kk * 8] : 0u;
          qf[kk][1] = row1 < Sq ? q1p[kk * 8] : 0u;
          qf[kk][2] = row0 < Sq ? q0p[kk * 8 + 4] : 0u;
          qf[kk][3] = row1 < Sq ? q1p[kk * 8 + 4] : 0u;
        }
      }
      // The tile's bias rows into the warp's table (zeros past Sq).
      __syncwarp();
      for (int i = lane; i < 16 * WB; i += 32) {
        const int r = i / WB, j = i % WB;
        const bool live = s0 + r < Sq;
        sBA[i] = __float2bfloat16(live ? p.bias_a(inst, s0 + r, j) : 0.f);
        sBB[i] = __float2bfloat16(live ? p.bias_b(inst, s0 + r, j) : 0.f);
      }
      if (it == 0) {  // K has landed
        cp_async_wait<1>();
        __syncthreads();
      }
      __syncwarp();  // the bias table is written

      float s[2 * NC][4];
      ww_qk_bf16<HD, NC>(s, qf, sK, lane);

      // Bias, scale, key mask, the row max over the quad. Key t = 8 j + c
      // (c = 2 tq + e % 2) has A's index t / WB = qj + w, w = (rj + c >= WB),
      // with 8 j = WB qj + rj known at compile time, and B's index t % WB,
      // which repeats with j % kPer. So a thread keeps its two rows' A terms
      // (at) and the kPer x 2 B terms its keys meet (bt) in registers, read
      // once a tile from the warp's table; `c0` is an opaque copy of 2 tq
      // taken in each tile, so that the compiler recomputes their indices
      // there rather than holding them across tiles.
      int c0;
      asm volatile("mov.b32 %0, %1;\n" : "=r"(c0) : "r"(2 * tq));
      float at[2][WB + 1], bt[2][kPer][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bf16* ta = sBA + (g + 8 * r) * WB;
        const bf16* tb = sBB + (g + 8 * r) * WB;
#pragma unroll
        for (int a = 0; a < WB; ++a) at[r][a] = __bfloat162float(ta[a]);
        at[r][WB] = 0.f;  // the index of a pad key past the last row
#pragma unroll
        for (int jj = 0; jj < kPer; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) bt[r][jj][e] = __bfloat162float(tb[(8 * jj + c0 + e) % WB]);
        }
      }
      float mx[2][4];  // four partial maxima a row (exact): short dependency chains
#pragma unroll
      for (int i = 0; i < 8; ++i) mx[i / 4][i % 4] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * NC; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int c = c0 + (e & 1);
          float x = -INFINITY;  // the pad keys past kKeys
          if (8 * j < kKeys) {
            const int qj = (8 * j) / WB, rj = (8 * j) % WB;
            const float bias = (rj + c >= WB ? at[r][qj + 1] : at[r][qj]) + bt[r][j % kPer][e & 1];
#ifdef ULLAVA_MUTANT_PACKED_BIAS_PRESCALED
            x = (s[j][e] + bias) * sl2;  // the bias read as if pre-scaled by 1/scale
#else
            x = s[j][e] * sl2 + bias * kLog2e;
#endif
            if (8 * j + 7 >= kKeys && 8 * j + c >= kKeys) x = -INFINITY;
          }
          s[j][e] = x;
          mx[r][(j % 2) * 2 + (e & 1)] = fmaxf(mx[r][(j % 2) * 2 + (e & 1)], x);
        }
      }
      // Every row has live keys (kKeys > 0), so m is finite and l >= 1.
      float m[2], l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mt = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
#ifdef ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX
        m[r] = mt;
#else
        m[r] = quad_max(mt);
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
        l[r] = quad_sum(sum);
      }
      uint32_t pa[NC][4];
      ww_probs<NC>(s, l, pa);
      if (it == 0) {  // V has landed
        cp_async_wait<0>();
        __syncthreads();
      }

      float o[ND][4];
      ww_pv<HD, NC, kKeys>(o, pa, sV, lane);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int d = n * 8 + tq * 2;
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row0) + d) =
              __floats2bfloat162_rn(o[n][0], o[n][1]);
        if (row1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row1) + d) =
              __floats2bfloat162_rn(o[n][2], o[n][3]);
      }
    }
  }
}

template <int HD, int WB, class P, class G0, class G1, bool I8>
constexpr size_t window_whole_total_smem() {
  if constexpr (P::kBiasAfterScale)
    return window_whole_smem_bytes<HD, WB>();
  else
    return WwLayout<HD, WB, P, G0, I8>::kBytes;
}

// Sets the kernel's shared-memory attributes once (per instantiation).
template <int HD, int WB, class P, class G0, class G1, bool I8>
int window_whole_configure() {
  constexpr size_t smem = window_whole_total_smem<HD, WB, P, G0, G1, I8>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(window_whole_kernel<HD, WB, P, G0, G1, I8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_whole_kernel<HD, WB, P, G0, G1, I8>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

// Launches one block per instance on `stream`. K19 takes whole windows of
// WB x WB queries and keys only; K3 (whole windows) Sq rows from T to the
// NK the layout holds; K14 (kPadKeys) exactly its T rows.
template <int HD, int WB, class P, class G0 = WwRect<WB, WB>, class G1 = G0, bool I8 = false>
int launch_window_whole(const P& p, int num_inst, cudaStream_t stream) {
  if (const int err = window_whole_configure<HD, WB, P, G0, G1, I8>()) return err;
  if constexpr (P::kBiasAfterScale) {
    if (p.Sk != WB * WB || p.Sq != WB * WB) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr int T = G0::T;
    if (G1::T != T || (P::kPadKeys ? p.Sq != T : p.Sq < T || p.Sq > G0::NC * 16))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_inst == 0 || p.Sq == 0) return 0;
  window_whole_kernel<HD, WB, P, G0, G1, I8>
      <<<num_inst, kWwThreads, window_whole_total_smem<HD, WB, P, G0, G1, I8>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// {registers a thread, shared bytes a block (dynamic + static), local
// (spilled) bytes a thread, blocks an SM} of one instantiation, from
// cudaFuncGetAttributes and the occupancy calculator.
template <int HD, int WB, class P, class G0 = WwRect<WB, WB>, class G1 = G0, bool I8 = false>
int window_whole_attrs(int* out) {
  if (const int err = window_whole_configure<HD, WB, P, G0, G1, I8>()) return err;
  return func_attrs(window_whole_kernel<HD, WB, P, G0, G1, I8>, kWwThreads,
                    window_whole_total_smem<HD, WB, P, G0, G1, I8>(), out);
}

}  // namespace ullava
