// flash_attention_bwd_dkv (K16) and flash_attention_bwd_dq (K17), with
// their pre-pass flash_attention_bwd_delta: the backward of the causal
// flash attention K15 over row-major [B, S, H, 128] q/k/v/dO with per-batch
// kv_lens and a static q_offset (bf16, H == Hkv), built for Hopper (sm_90a)
// on wgmma and TMA.
//
// Replaces: ullava_tpu/ops/attention.py:576 flash_attention_bwd, its dkv
// pass (kernel _flash_bwd_dkv_kernel, :473, launched at :618) and its dq
// pass (kernel _flash_bwd_dq_kernel, :529, launched at :644). Both
// recompute the probabilities p = exp(s * scale - lse) tile by tile from
// the forward's logsumexp under the forward's exact mask, and take
// delta = rowsum(dO * O) (fp32, from the rounded output) as an input.
// What is computed is the plain version's (`ops/attention.py`
// flash_attention_bwd_plain): p rounded to bf16 for dV += P^T dO;
// dS = p (dP - delta) scale rounded to bf16 before dK += dS^T Q and
// dQ += dS K; fp32 sums, bf16 outputs; key rows at or past kv_len get
// exact zeros in dk and dv, and rows with lse = 1e30 get p = 0.
//
// Bound on the card at the stage-1 shape ([4, 1024, 32, 128], causal,
// kv_lens 1024/1000/777/513, 62.0e6 live scores): the five products
// S, dP, dV, dK, dQ are 10 * 128 FLOP a live score, 7.94e10 FLOP, 0.080
// ms at the bf16 peak; q, dO, lse, delta and the k, v rows below kv_lens
// read once and dk, dv and the fp32 dq accumulator written once are 257
// MB, 0.077 ms at 3.35 TB/s. Operations bound it, by a little. The
// two-kernel form it replaces ran seven products (S and dP in both),
// 1.11e11 FLOP.
//
// Design (FlashAttention-3's backward structure), three launches:
//   - Launch 0, the pre-pass: delta = rowsum(dO * O) in fp32 (half a warp
//     a row, 16 bytes a lane of each) and the fp32 dq accumulator zeroed,
//     in one pass over dO and O (136 MB at the stage-1 shape: bytes bound
//     it, 0.040 ms). The JAX package leaves delta to XLA (:590); the
//     einsum that stood here widened dO and O to fp32 and summed them as a
//     batched matrix-vector product: 0.41 ms on an H100 (the pre-pass line
//     of chip_smoke.py, `einsum_ms`), more than the fused pass.
//   - Launch 1 (K16's slot), one fused pass: one block per (b, h, 128-key
//     tile), heavy first: (b, h) in groups of 16, whose Q and dO stay in
//     L2 while the group runs, and within a group key tile 0 (which sees
//     every causal query tile) first. K and V of the block's keys load
//     once by TMA. A producer warp streams 64-row tiles of Q and dO by TMA,
//     with their lse (times log2 e; +inf past Sq) and delta, through a
//     two-stage mbarrier ring, from the first query tile the causal
//     diagonal lets see the key tile; none when the key tile starts at or
//     past kv_len, whose block then only writes zeros.
//   - Two consumer warpgroups, each owning 64 key rows and keeping dK and
//     dV (64 x 128 fp32 each) in registers. Per query tile:
//       S^T = K Q^T and dP^T = V dO^T on wgmma.m64n64k16, both operands in
//       shared memory (K-major); P^T = exp2(S^T scale log2 e - lse2) in
//       registers, lse and delta read by column from the staged tile, the
//       mask applied only on tiles that hold the diagonal or the kv_len
//       edge; dS^T = P^T (dP^T - delta) scale; dV += P^T dO and
//       dK += dS^T Q with A from registers in bf16 and B through the
//       transpose flag (the forward's P V pattern); dS^T in bf16 into a
//       shared 128 x 64 tile (double-buffered, so one barrier of both
//       warpgroups a tile orders it); dQ_partial (64 rows x 64 columns a
//       warpgroup: the two split the 128 head columns) = dS K over the
//       block's 128 keys, A read from the dS^T tile and B = K, both
//       through the transpose flag.
//   - dQ_partial goes to a 128-byte-swizzled fp32 staging tile, and one
//     thread a warpgroup adds it into an fp32 accumulator [B, Sq, H, 128]
//     with a TMA reduce-add (cp.reduce.async.bulk.tensor), which clips the
//     rows past Sq; the next tile's products run while it drains.
//   - setmaxnreg: 240 registers a consumer thread (dK, dV 128; S^T, dP^T
//     64 or P, dS packed 32 and dQ_partial 32 at the peak), 24 for the
//     producer; 198,696 bytes of shared memory, one block an SM.
//   - Launch 2 (K17's slot): dq = bf16(accumulator), elementwise.
// dk and dv have one owner a row, so they are bit-identical between two
// calls on the same inputs. dq's fp32 sums arrive by reduce-adds in an
// order that changes from run to run, so dq may differ between calls by
// about one bf16 ulp (its gate is 1e-2 of a row's largest value).
//
// Deliberate bugs, each compiled only into a copy of this source
// (`chip_smoke.py` builds them to show that the gates catch them):
//   ULLAVA_MUTANT_NO_DELTA           delta dropped from dS;
//   ULLAVA_MUTANT_DQ_NO_SCALE        the dS tile that feeds dQ unscaled;
//   ULLAVA_MUTANT_BWD_CAUSAL_SHIFT   a masked tile's causal bound lets each
//                                    row see one key past its own;
//   ULLAVA_MUTANT_DQ_ONE_WARPGROUP   only the first warpgroup's 64 keys of
//                                    a tile reach dQ.
#include "sm90.cuh"

namespace ullava {
namespace sm90 {
namespace bwd {

constexpr int kN = 128;        // keys a block
constexpr int kM = 64;         // query rows a streamed tile
constexpr int kStages = 2;     // Q/dO ring
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kGroup = 16;     // (b, h) pairs a group of the block order
constexpr uint32_t kKHalf = kN * 128;  // one 64-column half of a 128-row tile
constexpr uint32_t kQHalf = kM * 128;  // ... of a 64-row tile
constexpr uint32_t kDqBox = kM * 128;  // 64 rows x 32 fp32 columns
// Offsets from the 1024-aligned base: K | V | Q stages | dO stages |
// two dS^T tiles | dQ staging (two boxes a warpgroup) | lse2, delta
// stages | mbarriers.
constexpr uint32_t kOffV = 2 * kKHalf;
constexpr uint32_t kOffQ = 4 * kKHalf;
constexpr uint32_t kOffDO = kOffQ + kStages * 2 * kQHalf;
constexpr uint32_t kOffDS = kOffDO + kStages * 2 * kQHalf;
constexpr uint32_t kOffDQ = kOffDS + 2 * kKHalf;
constexpr uint32_t kOffLD = kOffDQ + 4 * kDqBox;
constexpr uint32_t kOffBar = kOffLD + kStages * 2 * kM * 4;
constexpr size_t kSmemBytes = 1024 + kOffBar + 8 * (1 + 2 * kStages);
constexpr int kFinishThreads = 256;  // the pre-pass and the dq finish

#ifdef ULLAVA_MUTANT_BWD_CAUSAL_SHIFT
constexpr int kCausalShift = 1;
#else
constexpr int kCausalShift = 0;
#endif
#ifdef ULLAVA_MUTANT_DQ_ONE_WARPGROUP
constexpr int kDqSteps = kN / 32;
#else
constexpr int kDqSteps = kN / 16;
#endif

struct Params {
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const int* kv_lens;
  bf16* dk;
  bf16* dv;
  int B, Sq, Sk, H, q_offset, causal, n_kt;
  float scale, sl2;  // scale, scale * log2(e)
};

// One block: a 128-key tile of one (b, h), its key limit, and the query
// tiles it walks (q_lo, q_lo + 64, ...; n_q of them).
struct Work {
  int b, h, k0, key_limit, q_lo, n_q;
};

// Item w of the heavy-first order: (b, h) in groups of kGroup; within a
// group the key tiles in ascending order (the longest causal query span
// first), then (b, h).
__device__ __forceinline__ Work work_item(const Params& p, int w) {
  const int bh_count = p.B * p.H;
  const int G = min(kGroup, bh_count);
  const int per_group = G * p.n_kt;
  const int grp = w / per_group, in_g = w % per_group;
  const int g_size = min(G, bh_count - grp * G);
  const int bh = grp * G + in_g % g_size;
  Work it;
  it.b = bh / p.H;
  it.h = bh % p.H;
  it.k0 = (in_g / g_size) * kN;
  it.key_limit = min(p.Sk, p.kv_lens[it.b]);  // keys >= this are masked
  // Row s sees key t iff t <= s + q_offset: the first row that sees key k0.
  it.q_lo = p.causal ? max(0, it.k0 - p.q_offset) / kM * kM : 0;
  it.n_q = it.k0 < it.key_limit && it.q_lo < p.Sq ? (p.Sq - it.q_lo + kM - 1) / kM : 0;
  return it;
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dq, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 1024-aligned for the swizzle
  unsigned char* const gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + kOffV;
  auto sQ = [&](int s) { return base + kOffQ + s * 2 * kQHalf; };
  auto sdO = [&](int s) { return base + kOffDO + s * 2 * kQHalf; };
  float* const sLD = reinterpret_cast<float*>(gbase + kOffLD);  // [stage][lse2 | delta]
  const uint32_t bar_kv = base + kOffBar;
  auto full = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_kv + 8 * (1 + kStages + s); };

  const Work it = work_item(p, blockIdx.x);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA's expect-tx and the 32 lse/delta writers
      mbar_init(empty(s), 8);      // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  if (wg == 0) {
    // Producer: warp 0 streams the query tiles (one thread issues the
    // copies, the 32 lanes stage lse and delta); the rest of the
    // warpgroup gives its registers back and ends.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x < 32 && it.n_q > 0) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 4 * kKHalf);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          tma_load(sK + hh * kKHalf, &tm_k, bar_kv, 64 * hh, it.h, it.k0, it.b);
          tma_load(sV + hh * kKHalf, &tm_v, bar_kv, 64 * hh, it.h, it.k0, it.b);
        }
      }
      const size_t row_base = static_cast<size_t>(it.b * p.H + it.h) * p.Sq;
      for (int j = 0; j < it.n_q; ++j) {
        const int s = j % kStages, q0 = it.q_lo + j * kM;
        if (j >= kStages) mbar_wait(empty(s), ((j / kStages) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(full(s), 4 * kQHalf);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            tma_load(sQ(s) + hh * kQHalf, &tm_q, full(s), 64 * hh, it.h, q0, it.b);
            tma_load(sdO(s) + hh * kQHalf, &tm_do, full(s), 64 * hh, it.h, q0, it.b);
          }
        }
        float* ld = sLD + s * 2 * kM;
        for (int i = lane; i < kM; i += 32) {
          const int row = q0 + i;
          constexpr float kLog2e = 1.4426950408889634f;
          // Rows past Sq: zero Q and dO, and p = exp2(-inf) = 0.
          ld[i] = row < p.Sq ? p.lse[row_base + row] * kLog2e : INFINITY;
          ld[kM + i] = row < p.Sq ? p.delta[row_base + row] : 0.f;
        }
        mbar_arrive(full(s));
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns the tile's keys 64 cw .. 64 cw + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int g = lane / 4, tq = lane % 4;  // row in the 8-row group, thread in quad
  const int kr0 = cw * 64 + warp * 16 + g;  // this thread's keys: kr0, kr0 + 8 of the tile
  float dk[2][32], dv[2][32];  // head columns 64 hh .. 64 hh + 63
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[hh][i] = dv[hh][i] = 0.f;
  auto fence_acc = [&] {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      reg_fence(dk[hh]);
      reg_fence(dv[hh]);
    }
  };

  if (it.n_q > 0) {
    const bool issuer = threadIdx.x % 128 == 0;
    const uint32_t k_wg = sK + cw * 64 * 128, v_wg = sV + cw * 64 * 128;
    const uint32_t stage_dq = base + kOffDQ + cw * 2 * kDqBox;
    unsigned char* const gdq = gbase + kOffDQ + cw * 2 * kDqBox;
    mbar_wait(bar_kv, 0);
    for (int j = 0; j < it.n_q; ++j) {
      const int s = j % kStages, q0 = it.q_lo + j * kM;
      mbar_wait(full(s), (j / kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T, this warpgroup's 64 keys x 64 rows.
      float st[32], dpt[32];
      fence_acc();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t ko = (kk / 4) * kKHalf + (kk % 4) * 32;
        const uint32_t qo = (kk / 4) * kQHalf + (kk % 4) * 32;
        if (kk == 0) {
          wgmma_ss64_first<0, 0>(st, desc_sw128(k_wg + ko), desc_sw128(sQ(s) + qo));
          wgmma_ss64_first<0, 0>(dpt, desc_sw128(v_wg + ko), desc_sw128(sdO(s) + qo));
        } else {
          wgmma_ss64<0, 0>(st, desc_sw128(k_wg + ko), desc_sw128(sQ(s) + qo));
          wgmma_ss64<0, 0>(dpt, desc_sw128(v_wg + ko), desc_sw128(sdO(s) + qo));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // P^T and dS^T in registers, packed to bf16 as the A operands of
      // dV and dK: for rows 16 kk .. + 15, the accumulator pairs
      // 8 kk .. 8 kk + 7 in order (keys g, g + 8; rows 2 tq, + 8).
      const float* ld = sLD + s * 2 * kM;
      const bool masked = it.k0 + kN > it.key_limit ||
                          (p.causal && it.k0 + kN - 1 > q0 + p.q_offset);
      uint32_t pa[16], da[16];
#ifdef ULLAVA_MUTANT_DQ_NO_SCALE
      uint32_t du[16];
#endif
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 8 * c + 2 * tq;  // rows col, col + 1 of the query tile
        const float2 l2 = *reinterpret_cast<const float2*>(ld + col);
        const float2 dl = *reinterpret_cast<const float2*>(ld + kM + col);
        float pv[4], ds[4];
#ifdef ULLAVA_MUTANT_DQ_NO_SCALE
        float dsu[4];
#endif
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * c + e;
          const float x = st[i] * p.sl2 - ((e & 1) ? l2.y : l2.x);
          bool ok = true;
          if (masked) {
            const int t = it.k0 + kr0 + 8 * (e >> 1);
            const int row = q0 + col + (e & 1);
            ok = t < it.key_limit && (!p.causal || t <= row + p.q_offset + kCausalShift);
          }
          pv[e] = ok ? exp2f(x) : 0.f;
#ifdef ULLAVA_MUTANT_NO_DELTA
          const float d = dpt[i];
#else
          const float d = dpt[i] - ((e & 1) ? dl.y : dl.x);
#endif
          ds[e] = pv[e] * d * p.scale;
#ifdef ULLAVA_MUTANT_DQ_NO_SCALE
          dsu[e] = pv[e] * d;
#endif
        }
        pa[2 * c] = pack_bf16(pv[0], pv[1]);
        pa[2 * c + 1] = pack_bf16(pv[2], pv[3]);
        da[2 * c] = pack_bf16(ds[0], ds[1]);
        da[2 * c + 1] = pack_bf16(ds[2], ds[3]);
#ifdef ULLAVA_MUTANT_DQ_NO_SCALE
        du[2 * c] = pack_bf16(dsu[0], dsu[1]);
        du[2 * c + 1] = pack_bf16(dsu[2], dsu[3]);
#endif
      }

      // dS^T into the shared tile of this parity: key rows of 128 bytes
      // (64 query rows), 16-byte chunks swizzled by the key's row in its
      // 8-row group, as TMA's 128-byte swizzle lays a tile out.
      unsigned char* const gds = gbase + kOffDS + (j & 1) * kKHalf;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#ifdef ULLAVA_MUTANT_DQ_NO_SCALE
          const uint32_t v = du[2 * c + r];
#else
          const uint32_t v = da[2 * c + r];
#endif
          *reinterpret_cast<uint32_t*>(gds + (kr0 + 8 * r) * 128 + ((c ^ g) << 4) + 4 * tq) = v;
        }

      // dV += P^T dO, dK += dS^T Q (A from registers, B through the
      // transpose flag), issued; then, once both warpgroups' dS^T are in
      // the tile, dQ_partial = dS K_half.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kM / 16; ++kk)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          wgmma_pv(dv[hh], pa + 4 * kk, desc_sw128(sdO(s) + hh * kQHalf + kk * 2048));
          wgmma_pv(dk[hh], da + 4 * kk, desc_sw128(sQ(s) + hh * kQHalf + kk * 2048));
        }
      wgmma_commit();
      fence_proxy_async();  // this thread's dS^T stores, before the dQ products read them
      if (issuer) bulk_wait_read<0>();  // the last tile's reduce has read the dQ staging
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      float dq[32];
      const uint32_t ds_tile = base + kOffDS + (j & 1) * kKHalf;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqSteps; ++kk) {
        if (kk == 0)
          wgmma_ss64_first<1, 1>(dq, desc_sw128(ds_tile + kk * 2048),
                                 desc_sw128(sK + cw * kKHalf + kk * 2048));
        else
          wgmma_ss64<1, 1>(dq, desc_sw128(ds_tile + kk * 2048),
                           desc_sw128(sK + cw * kKHalf + kk * 2048));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc();
      reg_fence(dq);
      reg_fence(pa);
      reg_fence(da);
      if (lane == 0) mbar_arrive(empty(s));  // Q and dO of stage s are read

      // dQ_partial (query rows 16 warp + g, + 8; head columns 64 cw +
      // 8 i + 2 tq, + 1) into two 32-column boxes, 128-byte swizzled.
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = warp * 16 + g + 8 * r;
          const int chunk = 2 * (i % 4) + (tq >> 1);
          *reinterpret_cast<float2*>(gdq + (i / 4) * kDqBox + row * 128 +
                                     ((chunk ^ g) << 4) + (tq & 1) * 8) =
              make_float2(dq[4 * i + 2 * r], dq[4 * i + 2 * r + 1]);
        }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
      if (issuer) {
        tma_reduce_add(&tm_dq, stage_dq, 64 * cw, it.h, q0, it.b);
        tma_reduce_add(&tm_dq, stage_dq + kDqBox, 64 * cw + 32, it.h, q0, it.b);
        bulk_commit();
      }
    }
    if (issuer) bulk_wait<0>();
  }

  // dk, dv: bf16, the tile's rows below Sk (zeros where no query tile ran).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = it.k0 + kr0 + 8 * r;
    if (key >= p.Sk) continue;
    const size_t off = ((static_cast<size_t>(it.b) * p.Sk + key) * p.H + it.h) * 128 + 2 * tq;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        *reinterpret_cast<__nv_bfloat162*>(p.dk + off + 64 * hh + 8 * c) =
            __floats2bfloat162_rn(dk[hh][4 * c + 2 * r], dk[hh][4 * c + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(p.dv + off + 64 * hh + 8 * c) =
            __floats2bfloat162_rn(dv[hh][4 * c + 2 * r], dv[hh][4 * c + 2 * r + 1]);
      }
  }
}

// delta[b, h, s] = sum_d dO[r, d] O[r, d] in fp32 for each row r = (b, s,
// h) of [B, Sq, H, 128], and the accumulator's row r zeroed: half a warp a
// row, eight values a lane; a lane past the last row still joins its
// warp's shuffles.
__global__ void __launch_bounds__(kFinishThreads)
    delta_kernel(const uint4* __restrict__ dO, const uint4* __restrict__ o,
                 float* __restrict__ delta, float4* __restrict__ dq_acc, int Sq, int H,
                 int64_t rows) {
  const int l16 = threadIdx.x % 16;
  const int64_t r = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / 16;
  const bool live = r < rows;
  float sum = 0.f;
  if (live) {
    const uint4 a = dO[r * 16 + l16], b = o[r * 16 + l16];
    const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
      sum += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (!live) return;
  dq_acc[r * 32 + 2 * l16] = make_float4(0.f, 0.f, 0.f, 0.f);
  dq_acc[r * 32 + 2 * l16 + 1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (l16 == 0) {
    const int64_t per_b = static_cast<int64_t>(Sq) * H;
    const int64_t b = r / per_b, rem = r % per_b;
    delta[(b * H + rem % H) * Sq + rem / H] = sum;
  }
}

// dq = bf16(acc), eight values a thread.
__global__ void __launch_bounds__(kFinishThreads)
    dq_finish_kernel(const float4* __restrict__ acc, uint4* __restrict__ dq, int64_t n8) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n8) return;
  const float4 a = acc[2 * i], b = acc[2 * i + 1];
  dq[i] = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                     pack_bf16(b.z, b.w));
}

// The 4-D view {d, head, row, batch} of a [batch, rows, heads, 128] tensor
// of `type`, read in boxes of {box_d, 1, box_rows, 1} with the 128-byte
// swizzle.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, size_t elem, const void* ptr,
                     int batch, int rows, int heads, int box_d, int box_rows) {
  const cuuint64_t dims[4] = {128, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(heads) * 128 * elem;
  const cuuint64_t strides[3] = {128 * elem, row_bytes, row_bytes * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_d), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  return encode_map(map, type, ptr, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

inline int configure() {
  static bool configured = false;
  if (!configured) {
    if (encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

}  // namespace bwd
}  // namespace sm90
}  // namespace ullava

// The pre-pass: delta [B, H, Sq] f32 = rowsum(dO * O) and dq_acc [B, Sq,
// H, 128] f32 zeroed; dO, o: [B, Sq, H, 128] bf16, rows = B * Sq * H.
ULLAVA_EXPORT int ullava_flash_attention_bwd_delta(const void* dO, const void* o, void* delta,
                                                   void* dq_acc, int Sq, int H, int rows,
                                                   void* stream) {
  using namespace ullava::sm90::bwd;
  if (rows <= 0) return 0;
  const int blocks = (rows + kFinishThreads / 16 - 1) / (kFinishThreads / 16);
  delta_kernel<<<blocks, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(dO), static_cast<const uint4*>(o), static_cast<float*>(delta),
      static_cast<float4*>(dq_acc), Sq, H, rows);
  return static_cast<int>(cudaGetLastError());
}

// The fused pass (K16): dk, dv [B, Sk, H, 128] bf16, and dq_acc [B, Sq, H,
// 128] f32 (zeroed by the pre-pass) += dS K. q, dO: [B, Sq, H, 128] bf16;
// k, v: [B, Sk, H, 128] bf16; lse, delta: [B, H, Sq] f32; kv_lens [B] int32.
ULLAVA_EXPORT int ullava_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, const void* kv_lens, void* dq_acc, void* dk, void* dv, int B, int Sq,
    int Sk, int H, int causal, int q_offset, float scale, void* stream) {
  using namespace ullava::sm90::bwd;
  if (const int err = configure()) return err;
  if (B == 0 || H == 0 || Sk == 0) return 0;
  constexpr auto kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tm_q{}, tm_k{}, tm_v{}, tm_do{}, tm_dq{};
  if (!make_map(&tm_k, kBf16, 2, k, B, Sk, H, 64, kN) ||
      !make_map(&tm_v, kBf16, 2, v, B, Sk, H, 64, kN))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq > 0 && (!make_map(&tm_q, kBf16, 2, q, B, Sq, H, 64, kM) ||
                 !make_map(&tm_do, kBf16, 2, dO, B, Sq, H, 64, kM) ||
                 !make_map(&tm_dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq_acc, B, Sq, H, 32, kM)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_kt = (Sk + kN - 1) / kN;
  const Params p{static_cast<const float*>(lse), static_cast<const float*>(delta),
                 static_cast<const int*>(kv_lens), static_cast<ullava::bf16*>(dk),
                 static_cast<ullava::bf16*>(dv), B, Sq, Sk, H, q_offset, causal != 0, n_kt,
                 scale, scale * 1.4426950408889634f};
  flash_bwd_kernel<<<n_kt * B * H, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, p);
  return static_cast<int>(cudaGetLastError());
}

// The dq finish (K17): dq [n] bf16 = dq_acc [n] f32, n a multiple of 8.
ULLAVA_EXPORT int ullava_flash_attention_bwd_dq(const void* dq_acc, void* dq, int n8,
                                                void* stream) {
  using namespace ullava::sm90::bwd;
  if (n8 <= 0) return 0;
  const int blocks = (n8 + kFinishThreads - 1) / kFinishThreads;
  dq_finish_kernel<<<blocks, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(dq_acc), static_cast<uint4*>(dq), n8);
  return static_cast<int>(cudaGetLastError());
}

// Registers, shared bytes, spills and blocks an SM of the fused pass
// (which = 0), the dq finish (1) or the pre-pass (2).
ULLAVA_EXPORT int ullava_flash_attention_bwd_attrs(int which, int* out) {
  using namespace ullava::sm90::bwd;
  if (which == 0) {
    if (const int err = configure()) return err;
    return ullava::func_attrs(flash_bwd_kernel, kThreads, kSmemBytes, out);
  }
  if (which == 1) return ullava::func_attrs(dq_finish_kernel, kFinishThreads, 0, out);
  return ullava::func_attrs(delta_kernel, kFinishThreads, 0, out);
}
