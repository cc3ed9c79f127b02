// flash_attention_bwd_dkv (K16) and flash_attention_bwd_dq (K17): the
// backward of the causal flash attention K15 over row-major [B, S, H, hd]
// q/k/v/dO with per-batch kv_lens and a static q_offset (hd 128, bf16,
// H == Hkv).
//
// Replaces: ullava_tpu/ops/attention.py:576 flash_attention_bwd, its dkv
// pass (kernel _flash_bwd_dkv_kernel, :473, launched at :618) and its dq
// pass (kernel _flash_bwd_dq_kernel, :529, launched at :644). Both
// recompute the probabilities p = exp(s * scale - lse) tile by tile from
// the forward's logsumexp under the forward's exact mask, and take
// delta = rowsum(dO * O) (fp32, from the rounded output) as an input.
//
// Bound on the card at the training shape (B=4, S=1024, H=32, causal):
// K16 does 6.9e10 FLOP of products (S, dP, dV, dK over the live half of
// the score matrix) and moves 202 MB (q, k, v, dO read once, lse and
// delta, dk and dv written): 69 us of bf16 tensor-core time against 60 us
// of HBM time, so operations bound it. K17 does 5.2e10 FLOP (S, dP, dQ)
// and moves 169 MB: 52 us against 50 us, operations again.
//
// Design: the mma.sync.m16n8k16 building blocks of flash_core.cuh, four
// warps of 16 rows each, fp32 accumulators in registers.
//  - K16: one block per (b, h, 64-key tile). The K and V tiles stay in
//    shared memory; the q tiles that can see them (from the causal
//    diagonal on, none at all when the tile starts at or past kv_len)
//    stream through a double-buffered cp.async ring with their lse and
//    delta. Per q tile a warp forms S^T = K Q^T for its 16 keys, P^T, then
//    dV += P^T dO (P^T rounded to bf16 straight from the score registers
//    into A fragments, as the TPU kernel rounds p to dO's type), dP^T = V
//    dO^T, dS^T = P^T (dP^T - delta) scale rounded to bf16, dK += dS^T Q.
//    dk and dv are written once, bf16; key rows at or past kv_len are
//    exact zeros (their p is 0).
//  - K17: one block per (b, h, 64-row q tile). Q and dO stay in shared
//    memory; K and V tiles stream as in the forward, up to min(kv_len,
//    causal bound). Per tile S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
// No atomics: each output row has one owner, so both are deterministic.
//
// ULLAVA_MUTANT_NO_DELTA (K16) and ULLAVA_MUTANT_DQ_NO_SCALE (K17) build
// deliberate bugs that only `chip_smoke.py` compiles, to show that the
// gates catch them.
//
// Not yet: wgmma/TMA, 128-row tiles with the S/P exchange through shared
// memory that FlashAttention-2 uses, or one fused dq/dkv pass.
#include "flash_core.cuh"

namespace ullava {

constexpr int kBwdHD = 128;
constexpr int kBwdLD = kBwdHD + 8;  // shared-memory row stride (bf16)
constexpr int kBwdTile = kBQ * kBwdLD;
// Six 64-row tiles (K16: K, V, 2 x Q, 2 x dO; K17: Q, dO, 2 x K, 2 x V)
// and two stages of 64 lse and 64 delta values.
constexpr size_t kBwdSmem = 6 * kBwdTile * sizeof(bf16) + 4 * kBQ * sizeof(float);
static_assert(kBQ == kBK, "the backward tiles are square");

struct AttnBwd {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dO;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const int* kv_lens;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int Sq, Sk, H, q_offset;
  bool causal;
  float scale;

  __device__ size_t q_off(int inst, int s) const {
    return ((static_cast<size_t>(inst / H) * Sq + s) * H + inst % H) * kBwdHD;
  }
  __device__ size_t k_off(int inst, int t) const {
    return ((static_cast<size_t>(inst / H) * Sk + t) * H + inst % H) * kBwdHD;
  }
  __device__ int key_limit(int inst) const { return min(Sk, kv_lens[inst / H]); }
  __device__ bool live(int s, int t, int limit) const {
    return s < Sq && t < limit && (!causal || t <= s + q_offset);
  }
};

constexpr float kBwdLog2e = 1.4426950408889634f;

// acc (16 x 8*NT fp32, accumulator layout) += A (16 x 64, four A
// fragments) * B, where B[kk][n] = tile[kk][n]: a 64-row tile of the ring
// read transposed by ldmatrix (dV += P^T dO, dK += dS^T Q, dQ += dS K).
template <int NT>
__device__ __forceinline__ void mma_a_tile(float (&acc)[NT][4], const uint32_t (&a)[4][4],
                                           const bf16* tile, int lane, int chunks = 4) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= chunks) break;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, tile + (c * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * kBwdLD +
                               np * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * np], a[c], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a[c], b[2], b[3]);
    }
  }
}

// s (16 x 64 fp32) = rows[16 x 128] * tile[64 x 128]^T: `rows` are this
// warp's 16 rows of a shared-memory tile (A fragments by ldmatrix), `tile`
// the other operand's 64 rows (S = Q K^T, S^T = K Q^T, dP = dO V^T, ...).
__device__ __forceinline__ void mma_rows_tile(float (&s)[8][4], const bf16* rows,
                                              const bf16* tile, int lane, int chunks = 4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kBwdHD / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, rows + (lane & 15) * kBwdLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np >= chunks) break;
      uint32_t b[4];
      ldmatrix_x4(b, tile + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kBwdLD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The 16 x 64 accumulator tile rounded to bf16 as four A fragments of the
// next product (its columns become the reduction axis).
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&s)[8][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    a[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
    a[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
    a[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
    a[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
  }
}

// 16 x 128 fp32 accumulator rows -> bf16 rows of a [.., H, 128] tensor.
__device__ __forceinline__ void store_rows(bf16* out0, bf16* out1, const float (&acc)[16][4],
                                           int tq) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int d = n * 8 + tq * 2;
    if (out0 != nullptr)
      *reinterpret_cast<__nv_bfloat162*>(out0 + d) = __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    if (out1 != nullptr)
      *reinterpret_cast<__nv_bfloat162*>(out1 + d) = __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const AttnBwd p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBwdTile;
  bf16* sQ = sV + kBwdTile;        // [2][64][LD]
  bf16* sdO = sQ + 2 * kBwdTile;   // [2][64][LD]
  float* sL = reinterpret_cast<float*>(sdO + 2 * kBwdTile);  // [2][64] lse * log2(e)
  float* sD = sL + 2 * kBQ;                                   // [2][64] delta

  const int inst = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int Sq = p.Sq, Sk = p.Sk;
  const int limit = p.key_limit(inst);
  const int t0 = k0 + warp * 16 + g;  // this thread's key rows: t0, t0 + 8
  const bool warp_live = k0 + warp * 16 < limit;

  float dk[16][4], dv[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // The first q tile that can see key k0 (causal), none if the whole key
  // tile lies at or past kv_len.
  int q_lo = 0;
  if (p.causal) q_lo = max(0, k0 - p.q_offset) / kBQ * kBQ;
  const int q_end = k0 < limit ? Sq : q_lo;

  const bf16* valid = p.k + p.k_off(inst, 0);
  auto load_q = [&](int q0, int stage) {
    load_tile_async<kBwdHD>(sQ + stage * kBwdTile, [&](int r) {
      return q0 + r < Sq ? p.q + p.q_off(inst, q0 + r) : nullptr; }, valid, tid);
    load_tile_async<kBwdHD>(sdO + stage * kBwdTile, [&](int r) {
      return q0 + r < Sq ? p.dO + p.q_off(inst, q0 + r) : nullptr; }, valid, tid);
    for (int i = tid; i < kBQ; i += kThreads) {
      const bool in = q0 + i < Sq;
      sL[stage * kBQ + i] = in ? p.lse[static_cast<size_t>(inst) * Sq + q0 + i] * kBwdLog2e : 0.f;
      sD[stage * kBQ + i] = in ? p.delta[static_cast<size_t>(inst) * Sq + q0 + i] : 0.f;
    }
  };
  if (q_lo < q_end) {
    load_tile_async<kBwdHD>(sK, [&](int r) {
      return k0 + r < Sk ? p.k + p.k_off(inst, k0 + r) : nullptr; }, valid, tid);
    load_tile_async<kBwdHD>(sV, [&](int r) {
      return k0 + r < Sk ? p.v + p.k_off(inst, k0 + r) : nullptr; }, valid, tid);
    load_q(q_lo, 0);
  }
  const float sl2 = p.scale * kBwdLog2e;
  for (int q0 = q_lo, it = 0; q0 < q_end; q0 += kBQ, ++it) {
    if (q0 + kBQ < q_end) {
      load_q(q0 + kBQ, (it + 1) & 1);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tQ = sQ + (it & 1) * kBwdTile;
    const bf16* tdO = sdO + (it & 1) * kBwdTile;
    const float* tL = sL + (it & 1) * kBQ;
    const float* tD = sD + (it & 1) * kBQ;
    if (warp_live) {
      // P^T (16 keys x 64 queries), recomputed from lse.
      float pt[8][4];
      mma_rows_tile(pt, sK + warp * 16 * kBwdLD, tQ, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + tq * 2 + (e & 1);
          const bool ok = p.live(q0 + c, t0 + 8 * (e >> 1), limit);
          pt[j][e] = ok ? exp2f(pt[j][e] * sl2 - tL[c]) : 0.f;
        }
      uint32_t a[4][4];
      pack_a(a, pt);
      mma_a_tile(dv, a, tdO, lane);  // dV += P^T dO
      float dpt[8][4];
      mma_rows_tile(dpt, sV + warp * 16 * kBwdLD, tdO, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + tq * 2 + (e & 1);
#ifdef ULLAVA_MUTANT_NO_DELTA
          dpt[j][e] = pt[j][e] * dpt[j][e] * p.scale;
#else
          dpt[j][e] = pt[j][e] * (dpt[j][e] - tD[c]) * p.scale;
#endif
        }
      pack_a(a, dpt);
      mma_a_tile(dk, a, tQ, lane);  // dK += dS^T Q
    }
    __syncthreads();  // stage it & 1 is refilled at iteration it + 1
  }
  store_rows(t0 < Sk ? p.dk + p.k_off(inst, t0) : nullptr,
             t0 + 8 < Sk ? p.dk + p.k_off(inst, t0 + 8) : nullptr, dk, tq);
  store_rows(t0 < Sk ? p.dv + p.k_off(inst, t0) : nullptr,
             t0 + 8 < Sk ? p.dv + p.k_off(inst, t0 + 8) : nullptr, dv, tq);
}

__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const AttnBwd p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kBwdTile;
  bf16* sK = sdO + kBwdTile;      // [2][64][LD]
  bf16* sV = sK + 2 * kBwdTile;   // [2][64][LD]

  const int inst = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int Sq = p.Sq, Sk = p.Sk;
  const int limit = p.key_limit(inst);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const bool warp_live = q0 + warp * 16 < Sq;

  const bf16* valid = p.q + p.q_off(inst, 0);
  load_tile_async<kBwdHD>(sQ, [&](int r) {
    return q0 + r < Sq ? p.q + p.q_off(inst, q0 + r) : nullptr; }, valid, tid);
  load_tile_async<kBwdHD>(sdO, [&](int r) {
    return q0 + r < Sq ? p.dO + p.q_off(inst, q0 + r) : nullptr; }, valid, tid);
  const float sl2 = p.scale * kBwdLog2e;
  float lse2[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    const size_t i = static_cast<size_t>(inst) * Sq + row;
    lse2[r] = row < Sq ? p.lse[i] * kBwdLog2e : 0.f;
    delta[r] = row < Sq ? p.delta[i] : 0.f;
  }

  int kv_end = limit;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBQ, Sq) - 1 + p.q_offset + 1);
  auto load_kv = [&](int k0, int stage) {
    load_tile_async<kBwdHD>(sK + stage * kBwdTile, [&](int r) {
      return k0 + r < Sk ? p.k + p.k_off(inst, k0 + r) : nullptr; }, valid, tid);
    load_tile_async<kBwdHD>(sV + stage * kBwdTile, [&](int r) {
      return k0 + r < Sk ? p.v + p.k_off(inst, k0 + r) : nullptr; }, valid, tid);
  };
  float dq[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  if (kv_end > 0) load_kv(0, 0);
  for (int k0 = 0, it = 0; k0 < kv_end; k0 += kBK, ++it) {
    if (k0 + kBK < kv_end) {
      load_kv(k0 + kBK, (it + 1) & 1);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + (it & 1) * kBwdTile;
    const bf16* tV = sV + (it & 1) * kBwdTile;
    // 16-key chunks past the last key the loop must visit are masked.
    const int chunks = (min(kBK, kv_end - k0) + 15) / 16;
    if (warp_live) {
      float s[8][4], dp[8][4];
      mma_rows_tile(s, sQ + warp * 16 * kBwdLD, tK, lane, chunks);    // S = Q K^T
      mma_rows_tile(dp, sdO + warp * 16 * kBwdLD, tV, lane, chunks);  // dP = dO V^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool ok = p.live(r ? row1 : row0, k0 + j * 8 + tq * 2 + (e & 1), limit);
          const float pv = ok ? exp2f(s[j][e] * sl2 - lse2[r]) : 0.f;
#ifdef ULLAVA_MUTANT_DQ_NO_SCALE
          s[j][e] = pv * (dp[j][e] - delta[r]);
#else
          s[j][e] = pv * (dp[j][e] - delta[r]) * p.scale;
#endif
        }
      uint32_t a[4][4];
      pack_a(a, s);
      mma_a_tile(dq, a, tK, lane, chunks);  // dQ += dS K
    }
    __syncthreads();  // stage it & 1 is refilled at iteration it + 1
  }
  cp_async_wait<0>();  // Q and dO when no key tile ran
  store_rows(row0 < Sq ? p.dq + p.q_off(inst, row0) : nullptr,
             row1 < Sq ? p.dq + p.q_off(inst, row1) : nullptr, dq, tq);
}

template <class Kernel>
int launch_bwd(Kernel kernel, const AttnBwd& p, int num_inst, int tiles, cudaStream_t stream,
               bool& configured) {
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(kBwdSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (num_inst == 0 || tiles == 0) return 0;
  kernel<<<dim3(num_inst, tiles), kThreads, kBwdSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

AttnBwd make_bwd(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                 const void* delta, const void* kv_lens, void* dq, void* dk, void* dv, int Sq,
                 int Sk, int H, int causal, int q_offset, float scale) {
  return AttnBwd{static_cast<const bf16*>(q),      static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v),      static_cast<const bf16*>(dO),
                 static_cast<const float*>(lse),   static_cast<const float*>(delta),
                 static_cast<const int*>(kv_lens), static_cast<bf16*>(dq),
                 static_cast<bf16*>(dk),           static_cast<bf16*>(dv),
                 Sq, Sk, H, q_offset, causal != 0, scale};
}

}  // namespace ullava

// q, dO: [B, Sq, H, 128] bf16; k, v, dk, dv: [B, Sk, H, 128] bf16; lse,
// delta: [B, H, Sq] f32; kv_lens [B] int32.
ULLAVA_EXPORT int ullava_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, const void* kv_lens, void* dk, void* dv, int B, int Sq, int Sk, int H,
    int causal, int q_offset, float scale, void* stream) {
  static bool configured = false;
  const ullava::AttnBwd p = ullava::make_bwd(q, k, v, dO, lse, delta, kv_lens, nullptr, dk, dv,
                                             Sq, Sk, H, causal, q_offset, scale);
  return ullava::launch_bwd(ullava::flash_bwd_dkv_kernel, p, B * H,
                            (Sk + ullava::kBK - 1) / ullava::kBK,
                            static_cast<cudaStream_t>(stream), configured);
}

// q, dO, dq: [B, Sq, H, 128] bf16; k, v: [B, Sk, H, 128] bf16; lse, delta:
// [B, H, Sq] f32; kv_lens [B] int32.
ULLAVA_EXPORT int ullava_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, const void* kv_lens, void* dq, int B, int Sq, int Sk, int H, int causal,
    int q_offset, float scale, void* stream) {
  static bool configured = false;
  const ullava::AttnBwd p = ullava::make_bwd(q, k, v, dO, lse, delta, kv_lens, dq, nullptr,
                                             nullptr, Sq, Sk, H, causal, q_offset, scale);
  return ullava::launch_bwd(ullava::flash_bwd_dq_kernel, p, B * H,
                            (Sq + ullava::kBQ - 1) / ullava::kBQ,
                            static_cast<cudaStream_t>(stream), configured);
}
