// One online-softmax attention core shared by the three attention kernels
// of the port (LLaMA prefill, SAM window blocks, SAM global blocks).
//
// A block owns kBQ = 64 query rows of one attention instance (one
// (batch, head) or (window, head) pair): four warps, 16 rows each. Each
// warp keeps its Q rows, its 16 x 64 score tile and its 16 x HD fp32
// output accumulator in registers, in the accumulator layout of the
// tensor-core instruction mma.sync.m16n8k16 (bf16 in, fp32 accumulate),
// so the softmax statistics of a row live in the four threads of a quad
// and need two shuffles per reduction. Per tile of kBK = 64 keys:
//   1. K and V rows stream into shared memory with 16-byte cp.async
//      copies, double-buffered so the next tile loads while this one is
//      computed (rows past the key count are zero-filled; rows padded by
//      16 bytes so ldmatrix reads are bank-conflict free);
//   2. S = Q K^T on the tensor cores (ldmatrix for the K fragments);
//   3. the decomposed rel-pos bias (when WB > 0) is added from per-block
//      [64, WB] tables, the row is scaled and masked, and the running
//      max m and sum l are updated (fp32, base-2 exponentials with the
//      scale folded in);
//   4. P is rounded to bf16 straight from the score registers into the
//      A fragments of the second product (as the TPU kernels round p to
//      v.dtype), O is rescaled by exp(m_old - m_new) and O += P V runs on
//      the tensor cores (ldmatrix.trans for the V fragments).
// A row whose l stays 0 (every key masked) writes zeros.
//
// With EXPBF16 (the serving form of the SAM global kernel) the softmax
// works in natural units and follows the TPU kernel's rounding: s - m is
// rounded to bf16 before the exponential, the probability is rounded to
// bf16, and that rounded value is what l sums (in fp32) and P V uses.
//
// The problem type P supplies the layout: row pointers for q/k/v/o of an
// instance, the key limit, causal masking, and the per-row bias terms.
// The bias for key t = (a, b) = (t / WB, t % WB) of row s is
// biasA[s][a] + biasB[s][b], added to q.k before the scale; both terms are
// bf16 values, so the tables are staged in bf16 without rounding.
//
// When WB equals the key tile (the 64-wide global grid), every key of a
// tile shares one row a = k0 / W, so the A term is read once per row.
// Warps whose 16 rows all lie past Sq skip the products.
//
// In a tile that ends early (the 4 keys past 192 of a 196-token window,
// the causal diagonal), the products skip the 16-key chunks past the end.
//
// With DOTS_I8 (the int8 score form of the SAM kernels, `dots_i8`) step 2
// becomes an int8 product, as the TPU kernels' `_rq_rows` form computes it:
//   - the block quantizes its 64 Q rows once, and each K tile once after
//     its cp.async lands, per row to int8 codes (abs-max floored at 1e-12,
//     x * (127 / amax) as an IEEE division and a multiply, rounded half to
//     even) and an fp32 scale amax * (1 / 127), codes in a [64][HD8 + 16]
//     byte tile (HD8: HD rounded up to 32, the pad columns zero, which add
//     nothing), scales beside it;
//   - qk runs on mma.sync.m16n8k32 (s8 in, s32 accumulate), whose
//     accumulator layout is the fp32 layout of m16n8k16, so the softmax,
//     the bf16 P V product and the epilogues are those of the bf16 form;
//   - the bias terms' row [A | B] is quantized the same way when the
//     tables are staged, and the tables hold the codes (small integers,
//     exact in bf16): the score is float(acc) * (qs * ks) +
//     float(ca + cb) * abss, in that order of fp32 operations, then scaled;
//   - a problem with pad keys (P::kPadKeys, the boundary windows) gives
//     those keys the unquantized score q . k_pad + A + B (the TPU kernel's
//     bf16 dot against its constant pad table): q . k_pad is one value a
//     row, computed when Q is staged, and the raw A and B tables sit
//     beside the codes.
// Compiled with ULLAVA_MUTANT_I8_TILE_SCALE it dequantizes every key of a
// tile with the first key's scale: a deliberate bug that only
// `chip_smoke.py` builds, to show that the int8 forms' gate catches it.
// With DOTS_I8 off the kernel is the bf16 form, unchanged.
//
// Not yet: TMA, wgmma, warp specialisation, or packing the 4-row tail of
// a 196-row window with other windows' rows.
#pragma once

#include "common.cuh"

namespace ullava {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int HD, int WB>
constexpr size_t flash_smem_bytes() {
  return sizeof(bf16) * (4 * kBK * (HD + 8) + 2 * kBQ * WB);  // 2 stages of K and V
}

// DOTS_I8: the depth of the int8 product (HD rounded up to the 32 of one
// m16n8k32 step) and the byte stride of an int8 row (16 bytes past it, so
// that the 32-bit fragment loads of 8 rows hit 32 distinct banks).
template <int HD>
__host__ __device__ constexpr int i8_depth() {
  return (HD + 31) / 32 * 32;
}
template <int HD>
__host__ __device__ constexpr int i8_stride() {
  return i8_depth<HD>() + 16;
}

// What DOTS_I8 adds after the bias tables: the int8 tile (Q's codes at the
// start, then each K tile's), three fp32 arrays of 64 (the tile's scales,
// the bias rows' scales, q . k_pad) and, with pad keys, the raw bias tables.
template <int HD, int WB, class P, bool DOTS_I8>
constexpr size_t flash_total_smem_bytes() {
  if constexpr (DOTS_I8)
    return flash_smem_bytes<HD, WB>() + kBK * i8_stride<HD>() + 3 * kBQ * sizeof(float) +
           (P::kPadKeys ? sizeof(bf16) * 2 * kBQ * WB : 0);
  else
    return flash_smem_bytes<HD, WB>();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row) * b (32x8, col); int8 inputs, int32 accumulators.
// The accumulators are laid out as mma_bf16's.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Starts copying 64 rows of HD bf16 into shared memory (row stride
// HD + 8) with cp.async; `row(r)` returns the source row or nullptr for a
// zero row (a 0-byte copy from `valid`, which zero-fills).
template <int HD, class RowFn>
__device__ __forceinline__ void load_tile_async(bf16* dst, RowFn row, const bf16* valid,
                                                int tid) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = tid; i < 64 * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bf16* src = row(r);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * (HD + 8) + c)),
                 "l"(src != nullptr ? src + c : valid), "r"(src != nullptr ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Per-row int8 codes of 64 bf16 rows of HD (shared memory, row stride
// HD + 8) into `dst` (row stride i8_stride<HD>() bytes; columns from HD on
// are not written) and each row's scale into `scale`: `_rq_rows`, that is
// amax = max(max |x|, 1e-12), code = rn(x * (127 / amax)) with an IEEE
// division, scale = amax * (1 / 127). Two threads a row, kThreads = 128.
template <int HD>
__device__ __forceinline__ void quantize_rows_i8(const bf16* src, int8_t* dst, float* scale,
                                                 int tid) {
  constexpr int LD = HD + 8, HALF = HD / 2;
  static_assert(HALF % 4 == 0, "half a row must be whole 32-bit words of codes");
  const int r = tid >> 1, hf = tid & 1;
  const bf16* row = src + r * LD + hf * HALF;
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < HALF; c += 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + c));
    amax = fmaxf(amax, fmaxf(fabsf(v.x), fabsf(v.y)));
  }
  amax = fmaxf(fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1)), 1e-12f);
  const float inv = __fdiv_rn(127.f, amax);
  int8_t* out = dst + r * i8_stride<HD>() + hf * HALF;
#pragma unroll
  for (int c = 0; c < HALF; c += 4) {
    uint32_t w = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = __float2int_rn(__fmul_rn(__bfloat162float(row[c + i]), inv));
      w |= (static_cast<uint32_t>(q) & 0xffu) << (8 * i);
    }
    *reinterpret_cast<uint32_t*>(out + c) = w;
  }
  if (hf == 0) scale[r] = __fmul_rn(amax, 1.f / 127.f);
}

template <int HD, int WB, class P, bool EXPBF16 = false, bool DOTS_I8 = false>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const P p) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(!DOTS_I8 || (WB > 0 && kThreads == 2 * kBQ), "DOTS_I8 is the SAM kernels' form");
  constexpr int LD = HD + 8;  // shared-memory row stride (bf16)
  constexpr int KD = HD / 16;  // k-steps of Q K^T
  constexpr int KD8 = i8_depth<HD>() / 32;  // k-steps of the int8 Q K^T
  constexpr int LDI = i8_stride<HD>();      // int8 row stride (bytes)
  constexpr int ND = HD / 8;   // 8-wide column tiles of O
  constexpr int WBS = WB > 0 ? WB : 1;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [2][kBK][LD]
  bf16* sV = sK + 2 * kBK * LD;                   // [2][kBK][LD]
  bf16* sBA = sV + 2 * kBK * LD;                  // [kBQ][WB] (DOTS_I8: the A codes)
  bf16* sBB = sBA + kBQ * WB;                     // [kBQ][WB] (DOTS_I8: the B codes)
  // DOTS_I8 only (see flash_total_smem_bytes).
  int8_t* s8 = reinterpret_cast<int8_t*>(sBB + kBQ * WB);    // [kBK][LDI]
  float* sScale = reinterpret_cast<float*>(s8 + kBK * LDI);  // [64] the int8 tile's scales
  float* sAbs = sScale + kBQ;                                // [kBQ] bias rows' scales
  float* sPqk = sAbs + kBQ;                                  // [kBQ] q . k_pad
  bf16* sRA = reinterpret_cast<bf16*>(sPqk + kBQ);           // [kBQ][WB] raw A (pad keys)
  bf16* sRB = sRA + kBQ * WB;                                // [kBQ][WB] raw B

  const int inst = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // row in the 8-row group, thread in quad
  const int Sq = p.Sq, Sk = p.Sk;
  const int lrow0 = warp * 16 + g;        // this thread's local rows: lrow0, lrow0 + 8
  const int row0 = q0 + lrow0, row1 = row0 + 8;

  const bf16* valid = p.q_row(inst, 0);
  bf16* sQ = sK + kBK * LD;  // Q passes through the second K stage
  load_tile_async<HD>(sQ, [&](int r) { return q0 + r < Sq ? p.q_row(inst, q0 + r) : nullptr; },
                      valid, tid);
  if constexpr (DOTS_I8) {
    // Per-row int8 codes of the row's [A | B] (the quantization of
    // quantize_rows_i8): thread 2r takes A, 2r + 1 B, of local row r.
    const int r = tid >> 1, hf = tid & 1;
    const bool live = q0 + r < Sq;
    auto term = [&](int j) {
      return live ? (hf ? p.bias_b(inst, q0 + r, j) : p.bias_a(inst, q0 + r, j)) : 0.f;
    };
    float amax = 0.f;
    for (int j = 0; j < WB; ++j) {
      const float v = term(j);
      amax = fmaxf(amax, fabsf(v));
      if constexpr (P::kPadKeys) (hf ? sRB : sRA)[r * WB + j] = __float2bfloat16(v);
    }
    amax = fmaxf(fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1)), 1e-12f);
    const float inv = __fdiv_rn(127.f, amax);
    for (int j = 0; j < WB; ++j)
      (hf ? sBB : sBA)[r * WB + j] =
          __float2bfloat16(static_cast<float>(__float2int_rn(__fmul_rn(term(j), inv))));
    if (hf == 0) sAbs[r] = __fmul_rn(amax, 1.f / 127.f);
    // The int8 tile's pad columns [HD, HD8) stay zero for the whole block.
    constexpr int PADW = (LDI - 16 - HD) / 4;  // 32-bit words of pad a row
    for (int i = tid; i < kBK * PADW; i += kThreads)
      *reinterpret_cast<uint32_t*>(s8 + (i / PADW) * LDI + HD + (i % PADW) * 4) = 0u;
  } else if constexpr (WB > 0) {
    for (int i = tid; i < kBQ * WB; i += kThreads) {
      const int r = i / WB, j = i % WB;
      const bool live = q0 + r < Sq;
      sBA[i] = __float2bfloat16(live ? p.bias_a(inst, q0 + r, j) : 0.f);
      sBB[i] = __float2bfloat16(live ? p.bias_b(inst, q0 + r, j) : 0.f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DOTS_I8 ? 1 : KD][4];
  uint32_t qf8[DOTS_I8 ? KD8 : 1][4];  // DOTS_I8: Q's codes as m16n8k32 A fragments
  float q_scale[2] = {0.f, 0.f};       // DOTS_I8: the scales of rows row0, row1
  if constexpr (DOTS_I8) {
    quantize_rows_i8<HD>(sQ, s8, sScale, tid);
    if constexpr (P::kPadKeys) {
      // q . k_pad of local row r: every pad key of the instance has the
      // same k row. fp32 sum of the bf16 products, two threads a row.
      const int r = tid >> 1, hf = tid & 1;
      const bf16* qrow = sQ + r * LD + hf * (HD / 2);
      const bf16* krow = p.pad_k_row(inst) + hf * (HD / 2);
      float acc = 0.f;
      for (int c = 0; c < HD / 2; ++c)
        acc += __bfloat162float(qrow[c]) * __bfloat162float(krow[c]);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (hf == 0) sPqk[r] = acc;
    }
    __syncthreads();
    q_scale[0] = sScale[lrow0];
    q_scale[1] = sScale[lrow0 + 8];
#pragma unroll
    for (int kk = 0; kk < KD8; ++kk) {
      const int8_t* a = s8 + (warp * 16 + g) * LDI + kk * 32 + tq * 4;
      qf8[kk][0] = *reinterpret_cast<const uint32_t*>(a);
      qf8[kk][1] = *reinterpret_cast<const uint32_t*>(a + 8 * LDI);
      qf8[kk][2] = *reinterpret_cast<const uint32_t*>(a + 16);
      qf8[kk][3] = *reinterpret_cast<const uint32_t*>(a + 8 * LDI + 16);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  }
  // Warps whose 16 rows all lie past Sq (the last tile of a 196-row
  // window) skip the products; they still take part in the copies.
  const bool warp_live = q0 + warp * 16 < Sq;

  const int key_limit = p.key_limit(inst);  // keys >= this are masked
  int kv_end = key_limit;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBQ, Sq) - 1 + p.q_offset + 1);
  constexpr float kLog2e = 1.4426950408889634f;
  // Scores are kept in base-2 units (scale * log2(e) folded in) so that an
  // exponential is one exp2f; with EXPBF16 they stay in natural units,
  // where the TPU kernel rounds them, and `ex` converts.
  const float sl2 = EXPBF16 ? p.scale : p.scale * kLog2e;
  auto ex = [](float d) { return exp2f(EXPBF16 ? d * kLog2e : d); };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  auto load_kv = [&](int k0, int stage) {
    load_tile_async<HD>(sK + stage * kBK * LD,
                        [&](int r) { return k0 + r < Sk ? p.k_row(inst, k0 + r) : nullptr; },
                        valid, tid);
    load_tile_async<HD>(sV + stage * kBK * LD,
                        [&](int r) { return k0 + r < Sk ? p.v_row(inst, k0 + r) : nullptr; },
                        valid, tid);
  };
  __syncthreads();  // every warp holds its Q fragments before stage 1 is reused
  if (kv_end > 0) load_kv(0, 0);
  for (int k0 = 0, it = 0; k0 < kv_end; k0 += kBK, ++it) {
    // Double buffer: tile it+1 streams in while tile it is computed.
    if (k0 + kBK < kv_end) {
      load_kv(k0 + kBK, (it + 1) & 1);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + (it & 1) * kBK * LD;
    const bf16* tV = sV + (it & 1) * kBK * LD;
    const int tile_keys = min(kBK, kv_end - k0);  // keys of this tile the loop must visit
    if constexpr (DOTS_I8) {
      quantize_rows_i8<HD>(tK, s8, sScale, tid);
      __syncthreads();
    }
    if (warp_live) {
      float s[8][4];
      if constexpr (DOTS_I8) {
        int si[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll
        for (int kk = 0; kk < KD8; ++kk) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {  // 16 keys: two m16n8k32 products
            if (np * 16 >= tile_keys) break;  // past the last live key: masked anyway
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int8_t* b = s8 + ((2 * np + h2) * 8 + g) * LDI + kk * 32 + tq * 4;
              mma_s8(si[2 * np + h2], qf8[kk], *reinterpret_cast<const uint32_t*>(b),
                     *reinterpret_cast<const uint32_t*>(b + 16));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#ifdef ULLAVA_MUTANT_I8_TILE_SCALE
            const float ks = sScale[0];
#else
            const float ks = sScale[j * 8 + tq * 2 + (e & 1)];
#endif
            s[j][e] = __fmul_rn(static_cast<float>(si[j][e]), __fmul_rn(q_scale[e >> 1], ks));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {  // 16 keys per ldmatrix.x4
            if (np * 16 >= tile_keys) break;  // past the last live key: masked anyway
            uint32_t b[4];
            ldmatrix_x4(b, tK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                               ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
            mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
          }
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
      float a_tile[2] = {0.f, 0.f};
      if constexpr (WB == kBK) {
        a_tile[0] = __bfloat162float(sBA[lrow0 * WB + k0 / kBK]);
        a_tile[1] = __bfloat162float(sBA[(lrow0 + 8) * WB + k0 / kBK]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int srow = r ? row1 : row0;
          const int t = k0 + j * 8 + tq * 2 + (e & 1);
          const bool ok = srow < Sq && t < key_limit && (!p.causal || t <= srow + p.q_offset);
          float x = s[j][e];
          if constexpr (DOTS_I8) {
            // float(ca + cb) * abss; the code sum is exact in fp32.
            const int lr = lrow0 + r * 8;
            float codes;
            if constexpr (WB == kBK) {
              codes = a_tile[r] + __bfloat162float(sBB[lr * WB + (t - k0)]);
            } else {
              const int tb = ok ? t : 0;
              codes = __bfloat162float(sBA[lr * WBS + tb / WBS]) +
                      __bfloat162float(sBB[lr * WBS + tb % WBS]);
            }
            x = __fadd_rn(x, __fmul_rn(codes, sAbs[lr]));
            if constexpr (P::kPadKeys) {
              if (ok && p.pad_key(inst, t))  // the unquantized score of a pad key
                x = __fadd_rn(__fadd_rn(sPqk[lr], __bfloat162float(sRA[lr * WBS + t / WBS])),
                              __bfloat162float(sRB[lr * WBS + t % WBS]));
            }
          } else if constexpr (WB == kBK) {  // the tile is one key row a = k0 / W
            x += a_tile[r] + __bfloat162float(sBB[(lrow0 + r * 8) * WB + (t - k0)]);
          } else if constexpr (WB > 0) {
            const int lr = lrow0 + r * 8;
            const int tb = ok ? t : 0;  // keep masked keys' table reads in bounds
            x += __bfloat162float(sBA[lr * WBS + tb / WBS]) +
                 __bfloat162float(sBB[lr * WBS + tb % WBS]);
          }
          x *= sl2;
          s[j][e] = ok ? x : -INFINITY;
          mx[r] = fmaxf(mx[r], s[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = m_new == -INFINITY ? 1.f : ex(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
      uint32_t pa[4][4];  // P as the A fragments of four 16-key chunks
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float d = s[j][e] - m_run[r];
          if constexpr (EXPBF16) d = round_bf16(d);
          float pv = m_run[r] == -INFINITY ? 0.f : ex(d);
          if constexpr (EXPBF16) pv = round_bf16(pv);
          l_run[r] += pv;
          s[j][e] = pv;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
        pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
        pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c * 16 >= tile_keys) break;  // P is 0 there
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {  // 16 output columns per ldmatrix.x4
          uint32_t b[4];
          ldmatrix_x4_trans(b, tV + (c * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                                   np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa[c], b[0], b[1]);
          mma_bf16(o[2 * np + 1], pa[c], b[2], b[3]);
        }
      }
    }  // warp_live
    __syncthreads();  // stage it & 1 is refilled at iteration it + 1
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = l == 0.f ? 0.f : 1.f / l;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + tq * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row0) + d) =
          __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row1) + d) =
          __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

// Launches one block per (instance, 64-row query tile) on `stream`.
template <int HD, int WB, class P, bool EXPBF16 = false, bool DOTS_I8 = false>
int launch_flash(const P& p, int num_inst, cudaStream_t stream) {
  constexpr size_t smem = flash_total_smem_bytes<HD, WB, P, DOTS_I8>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD, WB, P, EXPBF16, DOTS_I8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (num_inst == 0 || p.Sq == 0) return 0;
  dim3 grid(num_inst, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<HD, WB, P, EXPBF16, DOTS_I8><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ullava
