// The wgmma + TMA flash attention forward for Hopper (sm_90a), shared by
// the training forward with logsumexp (K15, flash_fwd_sm90.cu: head dim
// 128, lse written) and the serving forward (K2, flash_attention.cu: head
// dims 128 and 64, no lse), over row-major [B, S, H, hd] q/k/v with
// per-batch kv_lens, a static q_offset, causal or not, and GQA (k/v head
// h / (H / Hkv)).
//
// What it computes, as the plain version `ops/attention.py`
// flash_attention_fwd_plain: keys stop at min(kv_len[b], Sk) and, causal,
// at row + q_offset; P is rounded to bf16 unnormalised for the P V product
// while l sums the fp32 p; o = acc / l in bf16 (zeros where l = 0); with
// LSE, lse = m + log l in natural units, fp32, [B, H, Sq] (1e30 where no
// key is live, so that the backward's recomputed exp(s - lse) is exactly 0).
//
// Design:
//   - One block per work item, a 128-row query tile of one (b, h), in a
//     heavy-first order: (b, h) in groups of 16, whose K and V stay in L2
//     while the group runs, and within a group the query tiles in
//     descending order (the longest causal key span first), then (b, h).
//     The key loop stops at min(kv_len, causal bound + q_offset); only the
//     tiles that hold the diagonal or the kv_len edge are masked. Rows from
//     kv_len to Sk are real data and keys past Sk come in as zeros (which
//     score 0, not -inf), so the kv_len edge is masked at kv_len itself.
//   - A block is a producer warpgroup (one thread issues every copy) and
//     two consumer warpgroups of 64 query rows each; setmaxnreg gives the
//     consumers 240 registers and the producer 24, which leaves one block
//     an SM at either head dim. Shared memory: Q and a ring of three K/V
//     stages, 225 KB at hd 128, 113 KB at hd 64.
//   - TMA: the tensor maps are built on the host (sm90.cuh's encoder) over
//     the 4-D view {d, head, row, batch}, passed as __grid_constant__
//     parameters. A 128-row tile is HD / 64 boxes of 64 columns (128 bytes,
//     one box at hd 64) with the 128-byte swizzle that wgmma reads; rows
//     past S come in as zeros. K and V tiles of 128 keys have full barriers
//     of their own (Q K^T starts before V lands) and share an empty one.
//   - S = Q K^T on wgmma.m64n128k16 with both operands in shared memory
//     (K-major); the softmax runs in the accumulator registers (a row's max
//     and sum take two shuffles in its quad), with scale * log2(e) folded
//     in and exp2; O += P V on wgmma.m64n64k16 (one a 64-column half) with
//     P from registers in bf16 and V from shared memory through the
//     transpose flag. A warpgroup issues Q K^T of tile j with P V of tile
//     j - 1 and runs tile j's softmax while that P V is on the tensor cores.
//   - The two warpgroups take turns to issue their products (FA3's
//     ping-pong, on two named barriers), so that one's softmax runs while
//     the other's products hold the tensor cores.
// Short sequences (the serving prefill's 320 rows, CLIP's 264) keep the
// 128-row tile: a 64-row tile with one consumer warpgroup would lose the
// ping-pong and read K and V twice as often, and two blocks an SM do not
// fit the registers the consumers need (sc, P and O: 160 at hd 64).
// Not yet: a persistent grid with a dynamic work queue, a cluster of two
// query tiles that share K and V by TMA multicast, a TMA store of O.
//
// Deliberate bugs, each compiled only into a copy of a source that
// includes this header (`chip_smoke.py` builds them to show that the gates
// catch them):
//   ULLAVA_MUTANT_LSE_NO_LOG        lse is m alone;
//   ULLAVA_MUTANT_CAUSAL_SHIFT      a masked tile's causal bound lets each
//                                   row see one key past its own;
//   ULLAVA_MUTANT_KV_EDGE_TILE_END  a kv_len-edge tile is masked at the
//                                   tile's end instead of at kv_len.
#pragma once

#include "sm90.cuh"

namespace ullava {
namespace sm90 {
namespace flash {

constexpr int kM = 128;        // query rows a block
constexpr int kN = 128;        // keys a tile
constexpr int kStages = 3;     // K/V ring
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr uint32_t kHalf = 128 * 64 * 2;  // one 64-column half of a 128-row tile
constexpr int kGroup = 16;  // (b, h) pairs a group of the block order
#ifdef ULLAVA_MUTANT_CAUSAL_SHIFT
constexpr int kCausalShift = 1;
#else
constexpr int kCausalShift = 0;
#endif

// Q | K stages | V stages | mbarriers, after 1 KB of alignment room.
template <int HD>
constexpr uint32_t kTileBytes = (HD / 64) * kHalf;
template <int HD>
constexpr uint32_t kBarOff = (1 + 2 * kStages) * kTileBytes<HD>;
template <int HD>
constexpr size_t kSmemBytes = 1024 + kBarOff<HD> + 8 * (1 + 3 * kStages);

struct Params {
  bf16* o;
  float* lse;  // nullptr without LSE
  const int* kv_lens;
  int B, Sq, Sk, H, Hkv, q_offset, causal, n_mt;
  float sl2;  // scale * log2(e)
};

// One work item: a 128-row query tile of one (b, h), with its key limit
// and the number of 128-key tiles it visits.
struct Work {
  int b, h, hk, q0, key_limit, n_tiles;
};

// Item w of the heavy-first order: (b, h) in groups of kGroup; within a
// group the query tiles in descending order, then (b, h).
__device__ __forceinline__ Work work_item(const Params& p, int w) {
  const int bh_count = p.B * p.H;
  const int G = min(kGroup, bh_count);
  const int per_group = G * p.n_mt;
  const int grp = w / per_group, in_g = w % per_group;
  const int g_size = min(G, bh_count - grp * G);
  const int mt = p.n_mt - 1 - in_g / g_size;
  const int bh = grp * G + in_g % g_size;
  Work it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.hk = it.h / (p.H / p.Hkv);
  it.q0 = mt * kM;
  it.key_limit = min(p.Sk, p.kv_lens[it.b]);  // keys >= this are masked
  int kv_end = it.key_limit;
  if (p.causal) kv_end = min(kv_end, min(it.q0 + kM, p.Sq) + p.q_offset);
  it.n_tiles = kv_end > 0 ? (kv_end + kN - 1) / kN : 0;
  return it;
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const Params p) {
  static_assert(HD == 64 || HD == 128, "head dim 64 or 128");
  constexpr int kHalves = HD / 64;
  constexpr uint32_t kTile = kTileBytes<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 1024-aligned for the swizzle
  const uint32_t sQ = base;
  auto sK = [&](int s) { return base + kTile * (1 + s); };
  auto sV = [&](int s) { return base + kTile * (1 + kStages + s); };
  const uint32_t bar_q = base + kBarOff<HD>;
  auto full_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + 2 * kStages + s); };

  const Work it = work_item(p, blockIdx.x);
  const int q0 = it.q0, key_limit = it.key_limit, n_tiles = it.n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy; the rest of the warpgroup
    // gives its registers back and ends.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0 && n_tiles > 0) {
      mbar_expect_tx(bar_q, kTile);
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
        tma_load(sQ + hh * kHalf, &tm_q, bar_q, 64 * hh, it.h, q0, it.b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty(s), ((j / kStages) - 1) & 1);
        mbar_expect_tx(full_k(s), kTile);
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
          tma_load(sK(s) + hh * kHalf, &tm_k, full_k(s), 64 * hh, it.hk, j * kN, it.b);
        mbar_expect_tx(full_v(s), kTile);
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
          tma_load(sV(s) + hh * kHalf, &tm_v, full_v(s), 64 * hh, it.hk, j * kN, it.b);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, tq = lane % 4;  // row in the 8-row group, thread in quad
  const uint32_t q_wg = sQ + cw * 64 * 128;  // this warpgroup's 64 rows of each Q half
  const int row0 = q0 + cw * 64 + warp * 16 + g, row1 = row0 + 8;
  float o[kHalves][32];  // output columns 64 hh .. 64 hh + 63
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[hh][i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float sc[64];     // this tile's scores, then its probabilities
  uint32_t pa[32];  // the previous tile's P, the register A operand of its P V
  float alpha[2];
#ifdef ULLAVA_MUTANT_KV_EDGE_TILE_END
  const int kv_mask_end = (key_limit + kN - 1) / kN * kN;
#else
  const int kv_mask_end = key_limit;
#endif

  auto qk = [&](int s) {  // S = Q K^T of stage s, issued (not waited for)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_qk(sc, desc_sw128(q_wg + (kk / 4) * kHalf + (kk % 4) * 32),
               desc_sw128(sK(s) + (kk / 4) * kHalf + (kk % 4) * 32), kk > 0);
    wgmma_commit();
  };
  auto pv = [&](int s) {  // O += P V of stage s with the P in pa, issued
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh)
        wgmma_pv(o[hh], pa + 4 * kk, desc_sw128(sV(s) + hh * kHalf + kk * 2048));
    wgmma_commit();
  };
  // Scale (base-2 units), mask the diagonal and kv_len tiles, the new
  // row max, alpha = exp2(m_old - m_new), p = exp2(s - m_new) into sc
  // and its sum into l (l scaled by alpha first).
  auto softmax = [&](int k0) {
    const bool masked =
        k0 + kN > key_limit || (p.causal && k0 + kN - 1 > q0 + p.q_offset);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      float x = sc[i] * p.sl2;
      if (masked) {
        const int t = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
        const int row = r ? row1 : row0;
        const bool ok =
            t < kv_mask_end && (!p.causal || t <= row + p.q_offset + kCausalShift);
        x = ok ? x : -INFINITY;
      }
      sc[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      alpha[r] = m_new == -INFINITY ? 1.f : exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = m_run[r] == -INFINITY ? 0.f : exp2f(sc[i] - m_run[r]);
      l_run[r] += sc[i];
    }
  };
  // P as the register A operand: for keys 16 kk .. + 15, the accumulator
  // pairs 8 kk .. 8 kk + 7 in order (rows g, g + 8; columns 2 tq, + 8).
  auto to_pa = [&] {
#pragma unroll
    for (int i = 0; i < 32; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
  };
  auto rescale = [&] {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float a = alpha[(i >> 1) & 1];
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh) o[hh][i] *= a;
    }
  };
  auto fence_o = [&] {
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) reg_fence(o[hh]);
  };

  // Tile j's softmax runs while tile j - 1's P V is on the tensor cores:
  // QK(j) and PV(j - 1) are issued together, QK(j) is waited for, the
  // softmax of j runs, then PV(j - 1) is waited for, its stage released
  // and O rescaled by j's alpha before PV(j) is issued.
  // Ping-pong: the warpgroups take turns to issue their products (named
  // barriers 1 and 2: warpgroup cw waits on 1 + cw, then lets the other go
  // on 2 - cw), so one's softmax runs beside the other's products. Both
  // take n_tiles + 1 turns; warpgroup 1 opens the first and leaves out its
  // last arrival, which no turn would wait for.
  auto turn_begin = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory"); };
  auto turn_end = [&](bool last) {
    if (!(cw == 1 && last)) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
  };
  if (n_tiles > 0 && cw == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
  if (n_tiles > 0) {
    mbar_wait(bar_q, 0);
    mbar_wait(full_k(0), 0);
    turn_begin();
    wgmma_fence();
    qk(0);
    turn_end(false);
    wgmma_wait<0>();
    reg_fence(sc);
    softmax(0);
    to_pa();
    for (int j = 1; j < n_tiles; ++j) {
      const int s = j % kStages, sp = (j - 1) % kStages;
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
      reg_fence(sc);
      softmax(j * kN);
      wgmma_wait<0>();  // P V of tile j - 1 is done
      fence_o();
      reg_fence(pa);
      if (lane == 0) mbar_arrive(empty(sp));
      rescale();
      to_pa();
    }
    const int sl = (n_tiles - 1) % kStages;
    mbar_wait(full_v(sl), ((n_tiles - 1) / kStages) & 1);
    reg_fence(pa);
    fence_o();
    turn_begin();
    wgmma_fence();
    pv(sl);
    turn_end(true);
    wgmma_wait<0>();
    fence_o();
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = l == 0.f ? 0.f : 1.f / l;
    if constexpr (LSE) {
      constexpr float kLn2 = 0.6931471805599453f;
#ifdef ULLAVA_MUTANT_LSE_NO_LOG
      const float lse = m_run[r] * kLn2;
#else
      const float lse = m_run[r] * kLn2 + logf(l);
#endif
      const int row = r ? row1 : row0;
      if (tq == 0 && row < p.Sq)
        p.lse[static_cast<size_t>(it.b * p.H + it.h) * p.Sq + row] = l == 0.f ? 1e30f : lse;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= p.Sq) continue;
    bf16* out = p.o + ((static_cast<size_t>(it.b) * p.Sq + row) * p.H + it.h) * HD + 2 * tq;
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(out + 64 * hh + 8 * i) = __floats2bfloat162_rn(
            o[hh][4 * i + 2 * r] * inv[r], o[hh][4 * i + 2 * r + 1] * inv[r]);
  }
}

// The 4-D view {d, head, row, batch} of a [batch, rows, heads, HD] bf16
// tensor, read in boxes of {64, 1, 128, 1} with the 128-byte swizzle.
template <int HD>
inline bool make_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads) {
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(heads) * HD * sizeof(bf16);
  const cuuint64_t strides[3] = {HD * sizeof(bf16), row_bytes, row_bytes * rows};
  const cuuint32_t box[4] = {64, 1, 128, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD, bool LSE>
int configure() {
  static bool configured = false;
  if (!configured) {
    if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<HD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes<HD>));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

// The kernel's registers, shared bytes, spills and blocks an SM.
template <int HD, bool LSE>
int attrs(int* out) {
  if (const int err = configure<HD, LSE>()) return err;
  return ullava::func_attrs(flash_fwd_sm90_kernel<HD, LSE>, kThreads, kSmemBytes<HD>, out);
}

// Launches the forward on `stream`: o [B, Sq, H, HD], and with LSE lse
// [B, H, Sq]; returns a CUDA error code.
template <int HD, bool LSE>
int launch_fwd(const void* q, const void* k, const void* v, const void* kv_lens, void* o,
               float* lse, int B, int Sq, int Sk, int H, int Hkv, int causal, int q_offset,
               float scale, cudaStream_t stream) {
  if (const int err = configure<HD, LSE>()) return err;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  CUtensorMap tm_q{}, tm_k{}, tm_v{};
  if (!make_map<HD>(&tm_q, q, B, Sq, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (Sk > 0 && (!make_map<HD>(&tm_k, k, B, Sk, Hkv) || !make_map<HD>(&tm_v, v, B, Sk, Hkv)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_mt = (Sq + kM - 1) / kM;
  Params p{static_cast<bf16*>(o), lse, static_cast<const int*>(kv_lens), B, Sq, Sk, H, Hkv,
           q_offset, causal != 0, n_mt, scale * 1.4426950408889634f};
  flash_fwd_sm90_kernel<HD, LSE><<<n_mt * B * H, kThreads, kSmemBytes<HD>, stream>>>(
      tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace sm90
}  // namespace ullava
