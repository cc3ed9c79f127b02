// An int8 x int8 -> int32 GEMM core for Hopper (sm_90a) on wgmma and TMA,
// with its epilogue a functor, and the cluster helpers that the
// chunk-pipelined MLP (K23, mlp_block_v2_int8.cu) shares. The fused W8A8 MLP (K12,
// mlp_block_int8.cu) runs both of its products on it, the dual LN1 + qkv
// of the resident window blocks (K13, ln_linear_int8.cu) its two in one
// launch, and the fused LN + linear and proj + residual (K10,
// ln_linear_int8.cu) its one.
//
//   acc[m, n] = sum_k A[m, k] * Bt[n, k]
// A is row-major int8 [M, K] (row stride lda); Bt is the port's int8
// weight, stored column-major: [N, K] with K contiguous (row stride ldb).
// 8-bit wgmma takes only K-major operands, and both are: no re-layout.
//
// Design:
//   - A block owns a 128 x 128 output tile: a producer warpgroup (one
//     thread issues every copy; setmaxnreg leaves it 24 registers) and two
//     consumer warpgroups of 64 rows each.
//   - TMA: A and Bt are 2-D tensor maps (sm90.cuh's encoder) read in boxes
//     of 128 rows x 128 bytes of K with the 128-byte swizzle that wgmma
//     reads; rows past M or N and bytes past K come in as zeros, so any M,
//     any N and any K whose row strides are multiples of 16 bytes are
//     taken. A k-block is 256 bytes of K, two boxes of each operand: a
//     ring of three 64 KB stages with one full barrier (transaction count)
//     and one empty barrier (8 warp arrivals) a stage.
//   - Each consumer warpgroup issues eight wgmma.m64n128k32.s32.s8.s8 a
//     k-block into 64 int32 registers a thread and keeps one k-block of
//     products in flight: it releases a stage once the products after it
//     are issued and the ones that read it are done. (128-byte k-blocks in
//     four or five stages, or two k-blocks in flight, ran 2-13% slower.)
//   - Before a tile's first product the core calls epi.begin(tile, state), so
//     that the epilogue's per-row and per-column operands can load while
//     the products run. K may be cut into chunks of `kt_per_chunk`
//     k-blocks: after the last k-block of each chunk the core waits for its
//     products and calls
//       epi.chunk(acc, chunk_index, tile, state)
//     and the next chunk's first product overwrites the accumulators; after
//     the last chunk it calls epi.finish(tile, state). Element i of acc sits
//     at (tile.row((i >> 1) & 1), tile.col(i >> 2) + (i & 1)).
//   - One block an SM (the consumers get 240 registers; two blocks an SM
//     would leave ptxas 80 registers a thread, fewer than a 64 x 128 int32
//     product needs). An epilogue that reduces across a thread block
//     cluster of `cluster_x` column tiles declares kClusterSyncs: the
//     producer warpgroup takes part in that many cluster barriers before it
//     ends. kScratchBytes of shared memory past the ring are the
//     epilogue's (`tile.scratch`); once every product of the block is done
//     it may also reuse the ring (`tile.ring`).
//   - Two weights, one launch: a second B tensor map (Bt2, [N2, K]) adds
//     ceil(N2 / 128) column tiles after B's ceil(N / 128); a tile reads
//     the weight of its part (tile.part 0 or 1, tile.N that weight's
//     width, tile.col0 counted from its first column), and the epilogue
//     picks its form by part. The A rows are read once for both (the
//     dual LN1 + qkv + bias-term product of K13, ln_linear_int8.cu).
//   - Compiled with ULLAVA_MUTANT_DUAL_TILE_OFFSET (a deliberate bug that
//     only chip_smoke.py builds, into a copy of ln_linear_int8.cu) Bt2's
//     tiles read their weight one tile over.
// Not yet: 128 x 256 tiles (the fc2 epilogue's fp32 sums would not fit
// the registers beside its int32 ones), a TMA store of the output,
// consumer warpgroups that alternate tiles (an epilogue still stalls the
// tensor cores). A persistent tile loop (one block an SM walking the
// tiles, the producer loading the next tile's k-blocks during the
// epilogue) ran K13 12-16% slower than one block a tile. TMA multicast of the A tile across fc1's cluster (each
// block loading 128 / cluster_x of its rows into all) was tried and ran
// slower: every block then waits for the slowest of its cluster.
#pragma once

#include "sm90.cuh"

namespace ullava {
namespace i8_sm90 {

constexpr int BM = 128, BN = 128;
constexpr int kBox = 128;  // bytes of K a TMA box (the 128-byte swizzle's row)
constexpr int kBoxes = 2;
constexpr int BK = kBox * kBoxes;  // bytes (int8 codes) of K a k-block
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr uint32_t kTileA = BM * BK, kTileB = BN * BK;
constexpr uint32_t kStage = kTileA + kTileB;
constexpr int kStages = 3;  // 192 KB of ring
constexpr uint32_t kBarOff = kStages * kStage;
constexpr uint32_t kScratchOff = kBarOff + 16 * kStages;  // full and empty barriers

template <class Epi>
constexpr size_t kSmemBytes = 1024 + kScratchOff + Epi::kScratchBytes;  // 1 KB to align

// Where a consumer thread's accumulators sit in the output.
struct Tile {
  int row0, col0;  // the tile's first row, and first column of its weight
  int M, N;        // N: the width of the tile's weight
  int part;        // 0: B's columns, 1: Bt2's
  int cw, warp;    // consumer warpgroup (0, 1), warp in it
  int g, tq;       // lane / 4, lane % 4
  int ct;          // consumer thread, 0 .. 255
  unsigned char* scratch;
  unsigned char* ring;

  __device__ __forceinline__ int lrow(int r) const { return cw * 64 + warp * 16 + g + 8 * r; }
  __device__ __forceinline__ int row(int r) const { return row0 + lrow(r); }
  __device__ __forceinline__ int lcol(int j) const { return 8 * j + 2 * tq; }
  __device__ __forceinline__ int col(int j) const { return col0 + lcol(j); }
};

// Every thread of the cluster (not .aligned: the producer's threads come
// divergent).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The 256 consumer threads of the block (named barrier 1).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The float at `p` (this block's shared memory) in the block of `rank`.
__device__ __forceinline__ float ld_peer(const float* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(sm90::smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Two bf16 values as loaded in one 32-bit word, as floats.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The grid is (n1 + n2 column tiles, row tiles): the first n1 column
// tiles read Bt, the rest Bt2.
template <class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_b2, int M, int N, int N2, int K,
                     int kt_per_chunk, int n1, const Epi epi) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 1024-aligned for the swizzle
  auto sA = [&](int s) { return base + s * kStage; };
  auto sB = [&](int s) { return base + s * kStage + kTileA; };
  auto full = [&](int s) { return base + kBarOff + 8 * s; };
  auto empty = [&](int s) { return base + kBarOff + 8 * (kStages + s); };
  const int KT = (K + BK - 1) / BK;
  const int part = blockIdx.x >= n1;
  const int row0 = blockIdx.y * BM, col0 = (blockIdx.x - (part ? n1 : 0)) * BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy; the warpgroup then takes
    // part in the epilogue's cluster barriers and ends.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const CUtensorMap* tb = part ? &tm_b2 : &tm_b;
#ifdef ULLAVA_MUTANT_DUAL_TILE_OFFSET
      const int bcol = part ? col0 + BN : col0;  // Bt2's tiles read one tile over
#else
      const int bcol = col0;
#endif
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(s), ((kt / kStages) - 1) & 1);
        mbar_expect_tx(full(s), kStage);
#pragma unroll
        for (int bx = 0; bx < kBoxes; ++bx) {
          tma_load(sA(s) + bx * BM * kBox, &tm_a, full(s), kt * BK + bx * kBox, row0, 0, 0);
          tma_load(sB(s) + bx * BN * kBox, tb, full(s), kt * BK + bx * kBox, bcol, 0, 0);
        }
      }
    }
    for (int i = 0; i < Epi::kClusterSyncs; ++i) cluster_sync();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int lane = threadIdx.x % 32;
  Tile t;
  t.row0 = row0;
  t.col0 = col0;
  t.M = M;
  t.N = part ? N2 : N;
  t.part = part;
  t.cw = wg - 1;
  t.warp = (threadIdx.x / 32) % 4;
  t.g = lane / 4;
  t.tq = lane % 4;
  t.ct = threadIdx.x - 128;
  t.ring = smem_raw + (base - raw);
  t.scratch = t.ring + kScratchOff;
  const uint32_t a_wg = t.cw * 64 * kBox;  // this warpgroup's 64 rows of an A box

  typename Epi::State state{};
  epi.begin(t, state);
  uint32_t acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;  // defined before its first (overwriting) product
  int pending = -1;  // the stage whose products are still in flight
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full(s), (kt / kStages) & 1);
    wgmma_fence();
    // A chunk's first product overwrites the sums.
    wgmma_s8(acc, desc_sw128(sA(s) + a_wg), desc_sw128(sB(s)), kt % kt_per_chunk != 0);
#pragma unroll
    for (int kk = 1; kk < BK / 32; ++kk)
      wgmma_qk_s8(acc, desc_sw128(sA(s) + (kk / 4) * BM * kBox + a_wg + 32 * (kk % 4)),
                  desc_sw128(sB(s) + (kk / 4) * BN * kBox + 32 * (kk % 4)));
    wgmma_commit();
    if ((kt + 1) % kt_per_chunk == 0 || kt + 1 == KT) {
      wgmma_wait<0>();
      reg_fence(acc);
      if (lane == 0) {
        if (pending >= 0) mbar_arrive(empty(pending));
        mbar_arrive(empty(s));
      }
      pending = -1;
      epi.chunk(acc, kt / kt_per_chunk, t, state);
    } else {
      wgmma_wait<1>();  // the products of k-block kt - 1 are done
      if (lane == 0 && pending >= 0) mbar_arrive(empty(pending));
      pending = s;
    }
  }
  epi.finish(t, state);
}

// The 2-D view of a row-major int8 [rows, K] matrix (row stride `ld`
// bytes), read in boxes of 128 rows x 128 bytes with the 128-byte swizzle.
inline bool make_map(CUtensorMap* map, const void* ptr, int rows, int K, int ld) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows), 1, 1};
  const cuuint64_t stride = static_cast<cuuint64_t>(ld);
  const cuuint64_t strides[3] = {stride, stride * rows, stride * rows};
  const cuuint32_t box[4] = {kBox, 128, 1, 1};
  return sm90::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

template <class Epi>
int configure() {
  static bool configured = false;
  if (!configured) {
    if (sm90::encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cudaError_t err =
        cudaFuncSetAttribute(gemm_sm90_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes<Epi>));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

// The kernel's registers, shared bytes, spills and blocks an SM.
template <class Epi>
int attrs(int* out) {
  if (const int err = configure<Epi>()) return err;
  return func_attrs(gemm_sm90_kernel<Epi>, kThreads, kSmemBytes<Epi>, out);
}

// Launches the GEMM of A with Bt (N columns) and Bt2 (N2 columns, or none
// where N2 is 0) with `epi` on `stream`, one block a tile; `cluster_x` > 1
// groups that many neighbouring column tiles into one thread block cluster
// (N / BN must then be a multiple of it, and N2 0). Returns a CUDA error
// code.
template <class Epi>
int launch_gemm2(const int8_t* A, int lda, int M, const int8_t* Bt, int ldb, int N,
                 const int8_t* Bt2, int ldb2, int N2, int K, int kt_per_chunk, const Epi& epi,
                 int cluster_x, cudaStream_t stream) {
  if (const int err = configure<Epi>()) return err;
  const int n1 = (N + BN - 1) / BN, n2 = (N2 + BN - 1) / BN;
  if (M == 0 || n1 + n2 == 0) return 0;
  CUtensorMap tm_a{}, tm_b{}, tm_b2{};
  if (!make_map(&tm_a, A, M, K, lda) || (N > 0 && !make_map(&tm_b, Bt, N, K, ldb)) ||
      (N2 > 0 && !make_map(&tm_b2, Bt2, N2, K, ldb2)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n1 + n2, (M + BM - 1) / BM);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes<Epi>;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_x > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gemm_sm90_kernel<Epi>, tm_a, tm_b, tm_b2, M,
                                             N, N2, K, kt_per_chunk, n1, epi);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One weight, one block a tile (K12's fc1 and fc2).
template <class Epi>
int launch_gemm(const int8_t* A, int lda, int M, const int8_t* Bt, int ldb, int N, int K,
                int kt_per_chunk, const Epi& epi, int cluster_x, cudaStream_t stream) {
  return launch_gemm2<Epi>(A, lda, M, Bt, ldb, N, nullptr, 0, 0, K, kt_per_chunk, epi,
                           cluster_x, stream);
}

}  // namespace i8_sm90
}  // namespace ullava
