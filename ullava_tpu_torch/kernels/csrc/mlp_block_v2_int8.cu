// fused_mlp_block_v2 (K23, w8a8, 2-D form): the chunk-pipelined int8 MLP,
// x + fc2(gelu(fc1(LN(x)))). The same function as fused_mlp_block's w8a8
// form (mlp_block_int8.cu), and bit for bit its output at the same f_chunk:
// the LN'd row quantized once, fc1 int8 x int8, the polynomial-erf GELU,
// its output re-quantized per row and per chunk of f_chunk columns, fc2
// int8 x int8 with each chunk's int32 sums rescaled by hs * s2 into an fp32
// sum in chunk order, then + b2 + x and one bf16 rounding. int32 sums are
// exact in any order, and every fp32 operation is K12's, in K12's order.
//
// Replaces: ullava_tpu/ops/mlp_kernel.py:314 fused_mlp_block_v2 (a Pallas
// kernel whose grid step k issues the fc1 product of chunk k into a parity
// double buffer before it runs the GELU, the re-quantization and the fc2
// product of chunk k - 1, so a chunk's intermediate never leaves VMEM).
//
// Bound on the card: at the microbenchmark's [150528, 1280] x 5120 the two
// products are 2 x 2 x T x C x F = 3.95e12 int8 operations, 2.0 ms at
// 1,979 TOP/s, against 0.79 GB of input and output (0.24 ms): operations
// bound it. K12 also writes and reads back the [T, F] int8 intermediate
// (0.77 GB at that shape); this kernel does not.
//
// Design: two launches.
//  1. the row pass of K12: LayerNorm + per-row int8 quantization
//     (ln_quant_rows.cuh), xq [T, C] int8 and xs [T] f32;
//  2. one kernel on wgmma + TMA (sm90.cuh) for the rest. A thread block
//     cluster of 8 blocks owns 128 rows. Each block is a producer warpgroup
//     (one thread issues every TMA copy; setmaxnreg leaves it 24 registers)
//     and two consumer warpgroups of 64 rows each (240 registers). Block r
//     owns fc1 columns [r, r + 1) x f_chunk / 8 of every chunk (N1 = 128 at
//     f_chunk 1024, 64 at 512) and fc2 output columns [r, r + 1) x 160: no
//     work is repeated, and each cluster of 128 rows reads each weight
//     once (15.4 GB from L2 at the microbenchmark's shape).
//     For chunk s:
//       a. fc1: a 128-byte k-block of xq's 128 rows and of the block's W1t
//          rows by TMA (both K-major, as 8-bit wgmma takes them, 128-byte
//          swizzle); the x rows are multicast: block r loads rows [16 r,
//          16 r + 16) into all 8 blocks' stages, so the cluster reads x
//          from L2 once, not 8 times. wgmma.m64nN1k32.s32.s8.s8, int32
//          sums in registers;
//       b. in the accumulator registers: h = gelu(acc * (xs * s1) + b1)
//          (K12's expression) and the block's partial row abs-max of it
//          (the quad that holds a row holds all N1 of the block's
//          columns); the maxima go to shared memory, and every consumer
//          warp arrives on `bar_amax` of all 8 blocks;
//       c. after its own `bar_amax` phase, each thread reads its two rows'
//          8 partial maxima through distributed shared memory (a quad
//          splits the 8 peers), amax = max(m, 1e-12), quantizes h by
//          127 / amax (a true division, then the product, rounded half to
//          even: K12's), and stores its int8 pairs into its own block's h
//          buffer at the block's columns;
//       d. the block's slice [128, N1] goes into the same place of the 7
//          peers' h buffers. At f_chunk 1024 it is exactly box r of the
//          chunk, 16 KB in one piece: one thread copies it to each peer by
//          cp.async.bulk (shared::cta to shared::cluster), completing on the
//          peer's `bar_h` as a transaction count. At 512 every thread
//          stores 16-byte pieces (st.shared::cluster), fences them against
//          the async proxy and every consumer warp arrives on `bar_h` of
//          all 8 blocks;
//       e. after its own `bar_h` phase: fc2 with A = the chunk's
//          [128, f_chunk] int8 h from the block's own shared memory and
//          B = the W2t slice [160, 128] by TMA, wgmma.m64n160k32 (80 int32
//          registers a thread), then acc2 += acc * (hs * s2) into 80 fp32
//          registers, in chunk order.
//     After the last chunk: + b2 + x, one bf16 rounding, the store. The
//     GELU intermediate lives in registers and shared memory only.
//   Barriers: a warp's arrival on another block's barrier that publishes
//   data is one fence.acq_rel.cluster by lane 0 and then plain arrivals,
//   one a block, waited on with acquire at cluster scope. A ring stage's x
//   part is written by all 8 blocks, so a stage is reused once every
//   block's consumers are done with it: the consumer warps release it on
//   their own block's `consumed`, and the block's producer, when it comes
//   to reuse the stage, forwards that to all 8 blocks' `empty` and waits
//   for all 8 forwards on its own. (Lane-parallel remote arrivals, lane p
//   to block p, stopped the card with an illegal instruction in every
//   variant tried; one lane arriving in each block in turn does not. The
//   cause is open: ULLAVA_EXPERIMENT_V2_LANE_ARRIVE builds that form.)
//   Each consumer waits for a k-block's
//   products before it releases the stage (faster than keeping one
//   k-block in flight with 3 stages).
//   The h buffer holds one chunk in the layout wgmma reads A from: f_chunk
//   / 128 boxes of [128 rows][128 bytes] with the 128-byte swizzle, so a
//   16-byte piece of a row keeps its 16 bytes together. One buffer, with
//   the two cluster barriers as its ordering (a second does not fit at
//   f_chunk 1024: 128 KB of h plus a 96 KB ring):
//     - a block writes chunk s + 1 into a peer's buffer (d) only after
//       `bar_amax` of s + 1, which the peer's warps reach only after their
//       fc2 of chunk s has read the buffer (wgmma waited);
//     - the partial maxima of s + 1 (b) are written after `bar_h` of s,
//       which the peers reach only after their reads of chunk s's (c) (the
//       bulk copies into a block are issued after its peers' reads);
//     - a barrier's phase s + 1 gets its first arrival only after the
//       block that owns it passed phase s;
//     - a bulk copy's source slice is rewritten at chunk s + 1 only after
//       `bar_amax` of s + 1, which every peer reaches after it received
//       the copy.
//   A block's last remote access to a peer precedes something the peer
//   waits for, except the bulk copies' reads of the sender's own slice: at
//   f_chunk 1024 one more round of `bar_amax` ends the kernel. One cluster
//   barrier at the start makes every block's barriers initialised before a
//   peer arrives on them.
//   Budgets: f_chunk 1024: ring 3 x 32 KB (an fc1 k-block: 16 KB of x and
//   16 KB of W1; an fc2 k-block: 20 KB of W2), h 128 KB, 231,000 bytes in
//   all; f_chunk 512: ring 6 x 24 KB, h 64 KB, 214,688 bytes. One block an
//   SM; fc1 of chunk s + 1 does not overlap the epilogue and fc2 of chunk
//   s (the registers would be 64 + 80 + 80 a thread); the producer's ring
//   runs ahead across both, so the next products' operands load while the
//   epilogue runs.
//
// `stages`: bit 0 the row pass, bit 1 fc1 with the GELU, the
// re-quantization and the exchange (a-d), bit 2 fc2 and the output (e), so
// each can be timed alone (6 = the main kernel, 7 = the function).
//
// Deliberate bugs for the correctness gate (chip_smoke.py), each built
// only into a copy of this source under its define:
//   ULLAVA_MUTANT_V2_BLOCK_AMAX   a block quantizes by its own partial row
//                                 abs-max, without the cluster's;
//   ULLAVA_MUTANT_V2_PREV_SCALE   fc2 folds chunk s with chunk s - 1's hs;
//   ULLAVA_MUTANT_V2_NO_FC1_BIAS  fc1's bias dropped;
//   ULLAVA_MUTANT_V2_PEER_OFFSET  a block's slice is written into each peer
//                                 at that peer's column offset.
#include "gelu_poly.cuh"
#include "int8_gemm_sm90.cuh"
#include "ln_quant_rows.cuh"

namespace ullava {
namespace v2 {

using i8_sm90::cluster_rank;
using i8_sm90::cluster_sync;
using i8_sm90::consumer_sync;
using i8_sm90::ld_peer;
using i8_sm90::load_bf16x2;
using i8_sm90::store_bf16x2;

constexpr int CL = 8;          // blocks a cluster
constexpr int BM = 128;        // rows a cluster: two consumer warpgroups of 64
constexpr int kC = 1280;       // SAM ViT-H's width
constexpr int N2 = kC / CL;    // fc2 output columns a block
constexpr int kBox = 128;      // bytes of K a TMA box and a k-block
constexpr int KT1 = kC / kBox;  // fc1 k-blocks a chunk
constexpr int kThreads = 384;
constexpr uint32_t kBoxBytes = BM * kBox;  // one [128 rows][128 bytes] box
constexpr int kXRows = BM / CL;  // x rows a block multicasts

template <int FC>
struct Cfg {
  static constexpr int N1 = FC / CL;     // fc1 columns a block a chunk
  static constexpr int KT2 = FC / kBox;  // fc2 k-blocks a chunk
  static constexpr uint32_t kTileW1 = N1 * kBox;
  static constexpr uint32_t kTileW2 = N2 * kBox;
  static constexpr uint32_t kFc1Bytes = kBoxBytes + kTileW1;
  static constexpr uint32_t kStage = kFc1Bytes > kTileW2 ? kFc1Bytes : kTileW2;
  static constexpr int kStages = FC == 1024 ? 3 : 6;
  static constexpr uint32_t kHOff = kStages * kStage;
  static constexpr uint32_t kAmaxOff = kHOff + FC * BM;
  static constexpr uint32_t kBarOff = kAmaxOff + BM * 4;
  static constexpr size_t kBytes = 1024 + kBarOff + 8 * (3 * kStages + 2);  // 1 KB to align
  static_assert(kStage % 1024 == 0 && kHOff % 1024 == 0, "swizzled tiles sit on 1024 bytes");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

#define ULLAVA_RR8(d, i)                                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// d[32] (+)= A (64 x 32 int8, shared) * B (64 x 32, shared, K-major), s32
// sums; overwritten where `accumulate` is 0.
__device__ __forceinline__ void wgmma_n64(uint32_t (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n"
      "}\n"
      : ULLAVA_RR8(d, 0), ULLAVA_RR8(d, 8), ULLAVA_RR8(d, 16), ULLAVA_RR8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same at N 160: d[80].
__device__ __forceinline__ void wgmma_n160(uint32_t (&d)[80], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, "
      "%73, %74, %75, %76, %77, %78, %79}, %80, %81, p;\n"
      "}\n"
      : ULLAVA_RR8(d, 0), ULLAVA_RR8(d, 8), ULLAVA_RR8(d, 16), ULLAVA_RR8(d, 24),
        ULLAVA_RR8(d, 32), ULLAVA_RR8(d, 40), ULLAVA_RR8(d, 48), ULLAVA_RR8(d, 56),
        ULLAVA_RR8(d, 64), ULLAVA_RR8(d, 72)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef ULLAVA_RR8

// fc1's product at the block's width N1 (128: the core's m64n128k32).
__device__ __forceinline__ void wgmma_fc1(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
  sm90::wgmma_s8(d, da, db, accumulate);
}
__device__ __forceinline__ void wgmma_fc1(uint32_t (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  wgmma_n64(d, da, db, accumulate);
}

// Arrives (the default release at CTA scope) on the barrier at this
// block's shared address `bar` in the block of `rank`: enough where the
// arrival only says that this block's reads of a ring stage are done.
__device__ __forceinline__ void arrive_peer_cta(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// Arrives on `bar` in every block of the cluster, once for the calling
// warp, releasing the warp's earlier writes at cluster scope: lane 0 fences
// once (fence.acq_rel.cluster, after `__syncwarp` has ordered the other
// lanes' writes before it) and then arrives in each block in turn.
// Built with -DULLAVA_EXPERIMENT_V2_LANE_ARRIVE, lane p arrives in block p
// after lane 0's fence instead: that form stopped the card with an
// illegal instruction (PERF.md, open questions); it is kept to isolate
// why, and no build of the port takes it.
__device__ __forceinline__ void arrive_all(uint32_t bar, int lane) {
  __syncwarp();
#ifdef ULLAVA_EXPERIMENT_V2_LANE_ARRIVE
  if (lane == 0) asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
  __syncwarp();
  if (lane < 8) arrive_peer_cta(bar, static_cast<uint32_t>(lane));
#else
  if (lane == 0) {
    asm volatile("fence.acq_rel.cluster;\n" ::: "memory");
    for (uint32_t p = 0; p < 8; ++p) arrive_peer_cta(bar, p);
  }
#endif
  __syncwarp();
}

// Waits (acquire, cluster scope) until the phase of parity `parity` of the
// barrier has completed.
__device__ __forceinline__ void wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Stores 16 bytes at this block's shared address `addr` in the block of
// `rank`.
__device__ __forceinline__ void st_peer(uint32_t addr, uint32_t rank, uint4 v) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "st.shared::cluster.v4.u32 [remote], {%2, %3, %4, %5};\n"
      "}\n" ::"r"(addr),
      "r"(rank), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
      : "memory");
}

// One 2-D box of `map` at (c0, c1) into shared address `dst` of every
// block in `mask`, completing on the barrier at the same address in each.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(0), "r"(0), "h"(mask)
      : "memory");
}

// Copies `bytes` from this block's shared address `src` to shared address
// `dst` of the block of `rank`, completing on that block's barrier at
// `bar` (a transaction count).
__device__ __forceinline__ void bulk_to_peer(uint32_t dst, uint32_t src, uint32_t bytes,
                                             uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 rdst, rbar;\n"
      "mapa.shared::cluster.u32 rdst, %0, %4;\n"
      "mapa.shared::cluster.u32 rbar, %3, %4;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [rdst], [%1], %2, [rbar];\n"
      "}\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar), "r"(rank)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// Byte offset of (row, column) of the chunk in the h buffer: box col / 128,
// the 128-byte swizzle (16-byte piece index ^ row % 8).
__device__ __forceinline__ uint32_t h_off(int row, int col) {
  return (col / kBox) * kBoxBytes + row * kBox + ((((col % kBox) / 16) ^ (row % 8)) * 16) +
         col % 16;
}

template <int FC>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_v2_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w1,
                  const __grid_constant__ CUtensorMap tm_w2, const float* __restrict__ xs,
                  const float* __restrict__ s1, const bf16* __restrict__ b1,
                  const float* __restrict__ s2, const bf16* __restrict__ b2,
                  const bf16* __restrict__ x, bf16* __restrict__ out, int M, int F, int stages) {
  using namespace sm90;
  using K = Cfg<FC>;
  constexpr int N1 = K::N1;
  constexpr bool kBulk = N1 == kBox;  // a block's slice is one whole box
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 1024-aligned for the swizzle
  unsigned char* gbase = smem_raw + (base - raw);
  auto stage = [&](int s) { return base + s * K::kStage; };
  auto full = [&](int s) { return base + K::kBarOff + 8 * s; };
  auto empty = [&](int s) { return base + K::kBarOff + 8 * (K::kStages + s); };
  auto consumed = [&](int s) { return base + K::kBarOff + 8 * (2 * K::kStages + s); };
  const uint32_t bar_amax = base + K::kBarOff + 24 * K::kStages;
  const uint32_t bar_h = bar_amax + 8;
  const uint32_t hbuf = base + K::kHOff;
  unsigned char* gh = gbase + K::kHOff;
  float* s_amax = reinterpret_cast<float*>(gbase + K::kAmaxOff);
  const uint32_t rank = cluster_rank();
  const int row0 = (blockIdx.x / CL) * BM;
  const int n = F / FC;
  const bool do_fc1 = stages & 2, do_fc2 = stages & 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(consumed(s), 8);  // this block's consumer warps
      mbar_init(empty(s), CL);    // every block's producer
    }
    mbar_init(bar_amax, 8 * CL);  // every consumer warp of the cluster
    mbar_init(bar_h, kBulk ? 1 : 8 * CL);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread walks the ring through every chunk's fc1 and
    // fc2 k-blocks in the order the consumers take them.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;
      // A stage is reused once every block's consumers are done with it
      // (each block's x rows reach every block's stage): this block's
      // producer forwards its consumers' release to every block's
      // `empty`, then waits for all 8 blocks' forwards on its own.
      auto next = [&](uint32_t bytes) {
        const int s = it % K::kStages;
        if (it >= K::kStages) {
          const uint32_t phase = ((it / K::kStages) - 1) & 1;
          mbar_wait(consumed(s), phase);
          for (uint32_t p = 0; p < CL; ++p) arrive_peer_cta(empty(s), p);
          mbar_wait(empty(s), phase);
        }
        mbar_expect_tx(full(s), bytes);
        ++it;
        return s;
      };
      for (int c = 0; c < n; ++c) {
        if (do_fc1)
          for (int kt = 0; kt < KT1; ++kt) {
            const int s = next(K::kFc1Bytes);
            // This block's 16 of the 128 x rows, into every block's stage.
            tma_load_multicast(stage(s) + rank * kXRows * kBox, &tm_x, full(s), kt * kBox,
                               row0 + static_cast<int>(rank) * kXRows, 0xff);
            tma_load(stage(s) + kBoxBytes, &tm_w1, full(s), kt * kBox,
                     c * FC + static_cast<int>(rank) * N1, 0, 0);
          }
        if (do_fc2)
          for (int kt = 0; kt < K::KT2; ++kt) {
            const int s = next(K::kTileW2);
            tma_load(stage(s), &tm_w2, full(s), c * FC + kt * kBox, static_cast<int>(rank) * N2,
                     0, 0);
          }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, ct = threadIdx.x - 128;
  const int wrow = cw * 64 + warp * 16 + g;  // local row of half 0; half 1 is 8 below
  float xr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + wrow + 8 * r;
    xr[r] = row < M ? xs[row] : 0.f;
  }
  float f[80];
#pragma unroll
  for (int i = 0; i < 80; ++i) f[i] = 0.f;
  float hs[2] = {1.f, 1.f};
#ifdef ULLAVA_MUTANT_V2_PREV_SCALE
  float hs_prev[2] = {1.f, 1.f};
#endif
  int it = 0;

  // The ring as the consumers walk it: `acquire` waits for k-block `it`'s
  // stage; `release`, once its products are issued, waits for them and
  // tells this block's producer that the stage is free.
  auto acquire = [&]() {
    const int s = it % K::kStages;
    mbar_wait(full(s), (it / K::kStages) & 1);
    wgmma_fence();
    return s;
  };
  auto release = [&](int s) {
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(consumed(s));
    ++it;
  };

  for (int c = 0; c < n; ++c) {
    if (do_fc1) {
      // a: fc1 of the block's N1 columns of chunk c.
      uint32_t acc[N1 / 2];
#pragma unroll
      for (int i = 0; i < N1 / 2; ++i) acc[i] = 0;
      for (int kt = 0; kt < KT1; ++kt) {
        const int s = acquire();
        const uint32_t a = stage(s) + cw * 64 * kBox, b = stage(s) + kBoxBytes;
        wgmma_fc1(acc, desc_sw128(a), desc_sw128(b), kt != 0);
#pragma unroll
        for (int kk = 1; kk < kBox / 32; ++kk)
          wgmma_fc1(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk), 1);
        release(s);
      }
      reg_fence(acc);

      // b: the GELU in the accumulator registers, the partial row maxima.
      const int colb = c * FC + static_cast<int>(rank) * N1;
      float rmax[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < N1 / 8; ++j) {
        const int col = colb + 8 * j + 2 * tq;
        const float2 w = *reinterpret_cast<const float2*>(s1 + col);
#ifdef ULLAVA_MUTANT_V2_NO_FC1_BIAS
        const float2 bb = make_float2(0.f, 0.f);
#else
        const float2 bb = load_bf16x2(b1 + col);
#endif
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, r = e >> 1;
          const float v = i8::gelu_poly(static_cast<float>(static_cast<int>(acc[i])) *
                                            (xr[r] * ((e & 1) ? w.y : w.x)) +
                                        ((e & 1) ? bb.y : bb.x));
          acc[i] = __float_as_uint(v);
          rmax[r] = fmaxf(rmax[r], fabsf(v));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = quad_max(rmax[r]);
        if (tq == 0) s_amax[wrow + 8 * r] = m;
      }
      arrive_all(bar_amax, lane);
      wait_cluster(bar_amax, c & 1);

      // c: the chunk's scales from the cluster's maxima; h quantized into
      // the block's columns of its own h buffer.
      float qs[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float* mine = s_amax + wrow + 8 * r;
#ifdef ULLAVA_MUTANT_V2_BLOCK_AMAX
        const float m = *mine;
#else
        const float m = quad_max(fmaxf(ld_peer(mine, tq), ld_peer(mine, tq + 4)));
#endif
        const float amax = fmaxf(m, 1e-12f);
        qs[r] = 127.0f / amax;
#ifdef ULLAVA_MUTANT_V2_PREV_SCALE
        hs_prev[r] = c > 0 ? hs[r] : amax * (1.0f / 127.0f);
#endif
        hs[r] = amax * (1.0f / 127.0f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = wrow + 8 * r;
#pragma unroll
        for (int j = 0; j < N1 / 8; ++j) {
          const int q0 = __float2int_rn(__uint_as_float(acc[4 * j + 2 * r]) * qs[r]);
          const int q1 = __float2int_rn(__uint_as_float(acc[4 * j + 2 * r + 1]) * qs[r]);
          const int col = static_cast<int>(rank) * N1 + 8 * j + 2 * tq;
          *reinterpret_cast<uint16_t*>(gh + h_off(lr, col)) =
              static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
        }
      }
      if constexpr (kBulk) {
        // d: the slice is box `rank` of the chunk, 16 KB in one piece: one
        // thread copies it into the 7 peers by the async proxy, each copy
        // completing on the peer's `bar_h`, and arms its own `bar_h` for
        // the 7 copies it receives.
        fence_proxy_async_all();  // the slice's generic stores before the async proxy reads them
        consumer_sync();
        if (ct == 0) {
#pragma unroll 1
          for (uint32_t p = 1; p < CL; ++p) {
            const uint32_t peer = (rank + p) % CL;
#ifdef ULLAVA_MUTANT_V2_PEER_OFFSET
            const uint32_t dst = hbuf + peer * kBoxBytes;
#else
            const uint32_t dst = hbuf + rank * kBoxBytes;
#endif
            bulk_to_peer(dst, hbuf + rank * kBoxBytes, kBoxBytes, bar_h, peer);
          }
          mbar_expect_tx(bar_h, (CL - 1) * kBoxBytes);
        }
        mbar_wait(bar_h, c & 1);
      } else {
        consumer_sync();
        // d: the block's slice into the 7 peers' h buffers, 16 bytes a store.
        constexpr int kPieces = N1 / 16;
#pragma unroll
        for (int k = 0; k < BM * kPieces / 256; ++k) {
          const int u = ct + 256 * k;
          const int row = u / kPieces, col = static_cast<int>(rank) * N1 + (u % kPieces) * 16;
          const uint32_t off = h_off(row, col);
          const uint4 v = *reinterpret_cast<const uint4*>(gh + off);
#pragma unroll
          for (uint32_t p = 1; p < CL; ++p) {
            const uint32_t peer = (rank + p) % CL;
#ifdef ULLAVA_MUTANT_V2_PEER_OFFSET
            st_peer(hbuf + h_off(row, static_cast<int>(peer) * N1 + (u % kPieces) * 16), peer, v);
#else
            st_peer(hbuf + off, peer, v);
#endif
          }
        }
        fence_proxy_async_all();  // these generic stores before the peers' products read them
        arrive_all(bar_h, lane);
        wait_cluster(bar_h, c & 1);
        fence_proxy_async_all();
      }
    }

    if (do_fc2) {
      // e: fc2 of chunk c from the h buffer, folded into f.
      uint32_t acc[80];
#pragma unroll
      for (int i = 0; i < 80; ++i) acc[i] = 0;
      for (int kt = 0; kt < K::KT2; ++kt) {
        const int s = acquire();
        const uint32_t a = hbuf + kt * kBoxBytes + cw * 64 * kBox, b = stage(s);
        wgmma_n160(acc, desc_sw128(a), desc_sw128(b), kt != 0);
#pragma unroll
        for (int kk = 1; kk < kBox / 32; ++kk)
          wgmma_n160(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk), 1);
        release(s);
      }
      reg_fence(acc);
#ifdef ULLAVA_MUTANT_V2_PREV_SCALE
      const float hr[2] = {hs_prev[0], hs_prev[1]};
#else
      const float hr[2] = {hs[0], hs[1]};
#endif
#pragma unroll
      for (int j = 0; j < N2 / 8; ++j) {
        const float2 w =
            *reinterpret_cast<const float2*>(s2 + static_cast<int>(rank) * N2 + 8 * j + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          f[i] += static_cast<float>(static_cast<int>(acc[i])) *
                  (hr[e >> 1] * ((e & 1) ? w.y : w.x));
        }
      }
    }
  }
  if (do_fc2) {
    // out = f + b2 + x, rounded once; rows past M are not stored.
#pragma unroll
    for (int j = 0; j < N2 / 8; ++j) {
      const int col = static_cast<int>(rank) * N2 + 8 * j + 2 * tq;
      const float2 bb = load_bf16x2(b2 + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + wrow + 8 * r;
        if (row >= M) continue;
        const size_t at = static_cast<size_t>(row) * kC + col;
        const float2 res = load_bf16x2(x + at);
        store_bf16x2(out + at, f[4 * j + 2 * r] + bb.x + res.x,
                     f[4 * j + 2 * r + 1] + bb.y + res.y);
      }
    }
  }
  if constexpr (kBulk) {
    // The block's copies of its last slice read its shared memory until
    // they complete: one more round of `bar_amax` (every block past its
    // last `bar_h`, so every copy done) before any block ends.
    if (do_fc1) {
      arrive_all(bar_amax, lane);
      wait_cluster(bar_amax, n & 1);
    }
  }
}

// The 2-D view of a row-major int8 [rows, K] matrix (row stride `ld`
// bytes), read in boxes of `box_rows` rows x 128 bytes with the 128-byte
// swizzle; rows past the view come in as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int K, int ld, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows), 1, 1};
  const cuuint64_t stride = static_cast<cuuint64_t>(ld);
  const cuuint64_t strides[3] = {stride, stride * rows, stride * rows};
  const cuuint32_t box[4] = {kBox, static_cast<cuuint32_t>(box_rows), 1, 1};
  return sm90::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int FC>
int configure() {
  static bool configured = false;
  if (!configured) {
    if (sm90::encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cudaError_t err =
        cudaFuncSetAttribute(mlp_v2_kernel<FC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(Cfg<FC>::kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

template <int FC>
int launch(const int8_t* xq, const float* xs, const int8_t* w1, const float* s1, const bf16* b1,
           const int8_t* w2, const float* s2, const bf16* b2, const bf16* x, bf16* out, int M,
           int F, int stages, cudaStream_t stream) {
  if (const int err = configure<FC>()) return err;
  if (M == 0) return 0;
  CUtensorMap tm_x{}, tm_w1{}, tm_w2{};
  if (!make_map(&tm_x, xq, M, kC, kC, kXRows) || !make_map(&tm_w1, w1, F, kC, kC, Cfg<FC>::N1) ||
      !make_map(&tm_w2, w2, kC, F, F, N2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ((M + BM - 1) / BM));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<FC>::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, mlp_v2_kernel<FC>, tm_x, tm_w1, tm_w2, xs, s1,
                                             b1, s2, b2, x, out, M, F, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int FC>
int attrs(int* out) {
  if (const int err = configure<FC>()) return err;
  return func_attrs(mlp_v2_kernel<FC>, kThreads, Cfg<FC>::kBytes, out);
}

}  // namespace v2
}  // namespace ullava

// x, out [rows, C] bf16; ln_s, ln_b, b2 [C] bf16; w1q int8 [F][C] (C
// contiguous), s1 [F] f32, b1 [F] bf16; w2q int8 [C][F] (F contiguous),
// s2 [C] f32. Scratch: xq [rows, C] int8, xs [rows] f32. C is 1280 (SAM
// ViT-H, the encoder the port builds); f_chunk is 512 or 1024 and divides F.
// `stages` as in the header.
ULLAVA_EXPORT int ullava_fused_mlp_block_v2_int8(const void* x, const void* ln_s, const void* ln_b,
                                                 const void* w1q, const void* s1, const void* b1,
                                                 const void* w2q, const void* s2, const void* b2,
                                                 void* out, void* xq, void* xs, int rows, int C,
                                                 int F, int f_chunk, float eps, int stages,
                                                 void* stream) {
  using namespace ullava;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != v2::kC || f_chunk <= 0 || F % f_chunk) return static_cast<int>(cudaErrorInvalidValue);
  if (stages & 1) {
    const int err = i8::launch_ln_quant_rows(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s),
        static_cast<const bf16*>(ln_b), static_cast<int8_t*>(xq), static_cast<float*>(xs), rows,
        C, eps, st);
    if (err != 0) return err;
  }
  if (!(stages & 6)) return 0;
  const auto args = [&](auto launch) {
    return launch(static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
                  static_cast<const int8_t*>(w1q), static_cast<const float*>(s1),
                  static_cast<const bf16*>(b1), static_cast<const int8_t*>(w2q),
                  static_cast<const float*>(s2), static_cast<const bf16*>(b2),
                  static_cast<const bf16*>(x), static_cast<bf16*>(out), rows, F, stages, st);
  };
  switch (f_chunk) {
    case 512:
      return args(v2::launch<512>);
    case 1024:
      return args(v2::launch<1024>);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the main
// kernel at `f_chunk` (512 or 1024).
ULLAVA_EXPORT int ullava_fused_mlp_block_v2_int8_attrs(int f_chunk, int* out) {
  using namespace ullava;
  if (f_chunk == 512) return v2::attrs<512>(out);
  if (f_chunk == 1024) return v2::attrs<1024>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
