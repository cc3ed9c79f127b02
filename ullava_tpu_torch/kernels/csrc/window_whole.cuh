// Whole-window attention for the packed SAM window kernel (K19): one block
// per (window, head) owns all the window's query rows, and each warp keeps
// the whole key row of its scores in registers, so the softmax normalises
// P before rounding it to bf16 exactly where the TPU kernel does
// (`_packed_window_kernel`, ullava_tpu/ops/sam_attention.py:791-822: the
// 196 x 196 scores, p = exp(s - m) / sum(p), p.astype(bf16), P V summed in
// fp32 with no final division) with no scores parked in shared memory and
// no second pass over the keys.
//
// Design (HD = 128 lanes, windows of at most kWwKeys = 208 keys: 196 for
// 14 x 14, padded to 13 chunks of 16):
//   - K and V of the instance are copied into shared memory once, with
//     16-byte cp.async copies, K and V in two groups so that Q K^T starts
//     while V lands; rows past the window are zero-filled. Rows are 256
//     bytes with the 16-byte chunks XOR-swizzled by the row's low three
//     bits, so the ldmatrix reads of 8 rows hit 32 distinct banks. 104 KB,
//     plus a 896-byte bias table a warp: two blocks an SM.
//   - The window's rows form 13 tiles of 16 (the last has 4 live rows)
//     over kWwWarps = 4 warps: warp w takes tiles w, w + 4, w + 8 (and 12).
//     Four warps give each thread 255 registers, which the score row (104
//     fp32 a thread: 26 accumulator tiles of mma.sync.m16n8k16) and Q's
//     fragments (32) need; eight would leave 128 and spill. A warp loads
//     its tile's Q fragments from global memory (read once), runs
//     S = Q K^T, adds the bias terms, scales, masks the pad keys, takes the
//     row max and sum over its quad (two shuffles each), and rounds
//     p = exp(s - m) / l to bf16 straight into the A fragments of O = P V.
//   - The bias terms A[s][t / W] and B[s][t % W] of the tile's 16 rows are
//     staged by the warp from global memory into its own table in shared
//     memory, and each thread reads the terms its keys meet into registers
//     once a tile: its rows' 14 A terms (key t's by a compile-time index
//     and a select) and the 7 x 2 B terms that t % 14 cycles through.
//   - Loads and products are the online core's (flash_core.cuh helpers);
//     O goes out as bf16 with no final division.
// The problem type declares kBiasAfterScale: s = q.k * scale + A + B, as
// the TPU's packed kernel adds the raw terms.
//
// Compiled with ULLAVA_MUTANT_WINDOW_NO_QUAD_MAX each thread normalises its
// scores by its own partial row max instead of the quad's: a deliberate bug
// that only `chip_smoke.py` builds, to show that K19's gate catches it.
#pragma once

#include "flash_core.cuh"

namespace ullava {

constexpr int kWwKeys = 208;  // keys a window can hold (13 chunks of 16)
constexpr int kWwWarps = 4;
constexpr int kWwThreads = kWwWarps * 32;
constexpr int kWwRowTiles = kWwKeys / 16;

template <int HD, int WB>
constexpr size_t window_whole_smem_bytes() {
  return sizeof(bf16) * (2 * kWwKeys * HD + kWwWarps * 2 * 16 * WB);
}

__host__ __device__ constexpr int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

// The byte offset of 16-byte chunk c of row r in a swizzled [rows][HD] tile.
template <int HD>
__device__ __forceinline__ int ww_offset(int r, int c) {
  return r * HD * 2 + ((c ^ (r & 7)) << 4);
}

template <int HD, int WB, class P>
__global__ void __launch_bounds__(kWwThreads, 2) window_whole_kernel(const P p) {
  static_assert(HD % 16 == 0 && HD / 8 >= 8, "rows of at least 8 chunks (the swizzle)");
  static_assert(WB > 0 && WB * WB <= kWwKeys, "a window of at most 208 keys");
  constexpr int KD = HD / 16;     // k-steps of Q K^T
  constexpr int ND = HD / 8;      // 8-wide column tiles of O
  constexpr int NC = kWwKeys / 16;  // 16-key chunks of a score row
  constexpr int CPR = HD / 8;     // 16-byte chunks a row
  constexpr int kKeys = WB * WB;  // a whole window: every query row sees every key
  constexpr int kPer = WB / gcd_int(8, WB);  // (8 j) % WB repeats with j % kPer
  static_assert(P::kBiasAfterScale, "the packed form: the bias goes in after the scale");
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(128) unsigned char smem_raw[];
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
#pragma unroll
    for (int j = 0; j < 2 * NC; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
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
    // p = exp(s - m) / l rounded to bf16, as the A fragments of 16-key
    // chunks. The quotient is the IEEE one, taken as q = a * (1 / l) and
    // one correction q + (a - q l) / l with fma (Markstein: exact for a
    // correctly rounded reciprocal and a normal quotient), three
    // operations in place of the general division's subroutine.
    const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
    uint32_t pa[NC][4];
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
    if (it == 0) {  // V has landed
      cp_async_wait<0>();
      __syncthreads();
    }

    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c * 16 >= kKeys) break;  // P is 0 there
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {  // 16 output columns per ldmatrix.x4
        uint32_t b[4];
        const int r = c * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(
                                 sV + ww_offset<HD>(r, 2 * np + (lane >> 4))));
        mma_bf16(o[2 * np], pa[c], b[0], b[1]);
        mma_bf16(o[2 * np + 1], pa[c], b[2], b[3]);
      }
    }
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

// Launches one block per instance on `stream`; anything but a whole
// window of WB x WB queries and keys is refused.
template <int HD, int WB, class P>
int launch_window_whole(const P& p, int num_inst, cudaStream_t stream) {
  constexpr size_t smem = window_whole_smem_bytes<HD, WB>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(window_whole_kernel<HD, WB, P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_whole_kernel<HD, WB, P>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (p.Sk != WB * WB || p.Sq != WB * WB) return static_cast<int>(cudaErrorInvalidValue);
  if (num_inst == 0 || p.Sq == 0) return 0;
  window_whole_kernel<HD, WB, P><<<num_inst, kWwThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ullava
