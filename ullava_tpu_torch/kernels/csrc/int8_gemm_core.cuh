// An int8 x int8 -> int32 tensor-core GEMM core on mma.sync, which the
// chunk-pipelined MLP (K23, mlp_block_v2_int8.cu) runs on, and the row
// pass (LayerNorm + per-row int8 quantization, `launch_ln_quant_rows`)
// that K10, K12 and K13 run before their products on the wgmma + TMA core
// (int8_gemm_sm90.cuh).
//
//   acc[m, n] = sum_k A[m, k] * B[k, n]
// A is row-major int8 [M, K] (row stride lda). B is handed over as the
// port stores an int8 weight: column-major, i.e. Bt[n, k] with K
// contiguous per output column (row stride ldb), which is exactly the
// `row.col` operand order of mma.sync.m16n8k32.s8.
//
// A block of 256 threads owns a 128 x 128 output tile: 8 warps laid out
// 2 (M) x 4 (N), each holding a 64 x 32 tile as 4 x 4 mma accumulators
// (64 int32 registers). K is walked in tiles of 64 bytes through a
// 3-stage cp.async ring in shared memory (rows padded to 80 bytes so the
// 8 x 16-byte rows of an ldmatrix hit distinct banks). Rows past M,
// columns past N and k past K are zero-filled by 0-byte copies, so any
// M, any N that is a multiple of 8 and any K that is a multiple of 16 is
// taken; row strides and base pointers must be multiples of 16 bytes.
//
// The epilogue is a functor. K may be cut into chunks of `kt_per_chunk`
// k-tiles: after the last k-tile of each chunk the core calls
//   epi.chunk(acc, chunk_index, tile, state)
// and zeroes the accumulators (the fused MLP's second product rescales
// its int32 partial sums per 1024-wide chunk); after the last chunk it
// calls epi.finish(tile, state). A plain GEMM has one chunk. `tile`
// gives the global row and column of every accumulator element and the
// block's shared memory, which the epilogue may reuse after a
// __syncthreads().
//
// Not yet: wgmma, TMA, a persistent tile scheduler. mma.sync tops out
// well below the card's wgmma int8 rate.
#pragma once

#include "row_quant.cuh"

namespace ullava {
namespace i8 {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // shared-memory row stride in bytes
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int WARPS_N = 4;
constexpr int WM = 64, WN = 32;            // warp tile
constexpr int MI = WM / 16, NI = WN / 8;   // mma tiles per warp
constexpr int SMEM_BYTES = STAGES * (BM + BN) * LDS;  // 61440

using Acc = int[MI][NI][4];

struct NoState {};

// Where a thread's accumulators sit in the output. Element e of
// acc[mi][ni] is at (row(mi, e >> 1), col(ni) + (e & 1)).
struct Tile {
  int row0, col0;  // the block's first row and column
  int M, N;
  int wm, wn;      // the warp's position in the 2 x 4 layout
  int g, tq;       // lane / 4, lane % 4
  unsigned char* smem;

  __device__ __forceinline__ int lrow(int mi, int half) const {
    return wm * WM + mi * 16 + g + half * 8;
  }
  __device__ __forceinline__ int lcol(int ni) const { return wn * WN + ni * 8 + tq * 2; }
  __device__ __forceinline__ int row(int mi, int half) const { return row0 + lrow(mi, half); }
  __device__ __forceinline__ int col(int ni) const { return col0 + lcol(ni); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x32, row) * b (32x8, col); int8 inputs, int32 accumulators.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Starts copying a [128, BK] tile (rows row0.., bytes k0.. of a row-major
// int8 matrix with `nrows` rows of K bytes) into shared memory.
__device__ __forceinline__ void load_tile_async(int8_t* dst, const int8_t* src, int ld,
                                                int row0, int nrows, int k0, int K, int tid) {
  constexpr int VPR = BK / 16;  // 16-byte vectors per row
#pragma unroll
  for (int it = 0; it < 128 * VPR / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / VPR, c = (i % VPR) * 16;
    const bool ok = row0 + r < nrows && k0 + c < K;
    const int8_t* g = ok ? src + static_cast<size_t>(row0 + r) * ld + k0 + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * LDS + c)),
                 "l"(g), "r"(ok ? 16 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
}

template <class Epi>
__global__ void __launch_bounds__(THREADS, Epi::kMinBlocks)
    gemm_kernel(const int8_t* __restrict__ A, int lda, int M, const int8_t* __restrict__ Bt,
                int ldb, int N, int K, int kt_per_chunk, const Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sA = reinterpret_cast<int8_t*>(smem);  // [STAGES][BM][LDS]
  int8_t* sB = sA + STAGES * BM * LDS;            // [STAGES][BN][LDS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  Tile t;
  t.row0 = blockIdx.y * BM;
  t.col0 = blockIdx.x * BN;
  t.M = M;
  t.N = N;
  t.wm = warp / WARPS_N;
  t.wn = warp % WARPS_N;
  t.g = lane / 4;
  t.tq = lane % 4;
  t.smem = smem;

  const int KT = (K + BK - 1) / BK;
  auto load = [&](int kt, int stage) {
    load_tile_async(sA + stage * BM * LDS, A, lda, t.row0, M, kt * BK, K, tid);
    load_tile_async(sB + stage * BN * LDS, Bt, ldb, t.col0, N, kt * BK, K, tid);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }

  Acc acc;
  zero_acc(acc);
  typename Epi::State state = {};

  // This lane's ldmatrix rows: an A x4 covers 16 rows x 32 bytes, a B x4
  // covers 16 output columns x 32 bytes (two 8-column mma tiles).
  const int a_off = (t.wm * WM + (lane & 15)) * LDS + (lane >> 4) * 16;
  const int b_off = (t.wn * WN + (lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait_group<STAGES - 2>();  // tile kt has landed
    __syncthreads();                    // and the stage computed at kt - 1 is free
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const int8_t* tA = sA + (kt % STAGES) * BM * LDS + a_off;
    const int8_t* tB = sB + (kt % STAGES) * BN * LDS + b_off;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t af[MI][4], bfr[NI / 2][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) ldmatrix_x4(af[mi], tA + mi * 16 * LDS + kk * 32);
#pragma unroll
      for (int np = 0; np < NI / 2; ++np) ldmatrix_x4(bfr[np], tB + np * 16 * LDS + kk * 32);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_s8(acc[mi][ni], af[mi], bfr[ni / 2][(ni & 1) * 2], bfr[ni / 2][(ni & 1) * 2 + 1]);
    }
    if ((kt + 1) % kt_per_chunk == 0 || kt + 1 == KT) {
      epi.chunk(acc, kt / kt_per_chunk, t, state);
      zero_acc(acc);
    }
  }
  epi.finish(t, state);
}

// Launches the GEMM with `epi` on `stream`; `cluster_x` > 1 groups that
// many neighbouring column tiles into one thread block cluster (N / BN
// must then be a multiple of it).
template <class Epi>
int launch_gemm(const int8_t* A, int lda, int M, const int8_t* Bt, int ldb, int N, int K,
                int kt_per_chunk, const Epi& epi, int cluster_x, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (M == 0 || N == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_x > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, gemm_kernel<Epi>, A, lda, M, Bt, ldb, N, K,
                                       kt_per_chunk, epi);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// Row pass: optional LayerNorm (fp32 mean, biased variance, rsqrt, scale,
// bias) and per-row symmetric int8 quantization, one warp per row. The
// row (C <= 2048 bf16 values) is held in registers.
//   xs[row] = max(amax, 1e-12) / 127,  xq = rn(v * (127 / max(amax, 1e-12)))
// The LN products are kept unfused (no FMA) so that a row quantizes as
// the plain version's separate multiply and add do.
// ---------------------------------------------------------------------
constexpr int kRowMaxVec = 8;  // 8 x 32 lanes x 8 values = 2048 columns
constexpr int kRowWarps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Loads row `xr` into a lane's registers (vectors lane, lane + 32, ...
// of the row's C / 8) and, with LN, replaces it by its LayerNorm in fp32.
template <bool LN>
__device__ __forceinline__ void load_row(float (&v)[kRowMaxVec][8], const bf16* __restrict__ xr,
                                         const bf16* __restrict__ gamma,
                                         const bf16* __restrict__ beta, int lane, int C,
                                         float eps) {
  const int nv = C / 8;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    const int vec = lane + i * 32;
    if (vec < nv) {
      load_bf16x8(xr + vec * 8, v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[i][j];
    }
  }
  if (!LN) return;
  const float mean = warp_sum(sum) / static_cast<float>(C);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    if (lane + i * 32 < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[i][j] -= mean;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(C) + eps);
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    const int vec = lane + i * 32;
    if (vec < nv) {
      float gm[8], bt[8];
      load_bf16x8(gamma + vec * 8, gm);
      load_bf16x8(beta + vec * 8, bt);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], rstd), gm[j]), bt[j]);
    }
  }
}

template <bool LN>
__global__ void __launch_bounds__(kRowWarps * 32)
    ln_quant_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                         const bf16* __restrict__ beta, int8_t* __restrict__ xq,
                         float* __restrict__ xs, int rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int nv = C / 8;
  float v[kRowMaxVec][8];
  load_row<LN>(v, x + static_cast<size_t>(row) * C, gamma, beta, lane, C, eps);
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    if (lane + i * 32 < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  amax = fmaxf(warp_max(amax), 1e-12f);
  const float qs = 127.0f / amax;
  if (lane == 0) xs[row] = amax * (1.0f / 127.0f);
  int8_t* qr = xq + static_cast<size_t>(row) * C;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    const int vec = lane + i * 32;
    if (vec < nv) store_int8x8(qr + vec * 8, v[i], qs);
  }
}

// x [rows, C] bf16 -> xq [rows, C] int8, xs [rows] f32; gamma == nullptr
// skips the LayerNorm.
inline int launch_ln_quant_rows(const bf16* x, const bf16* gamma, const bf16* beta, int8_t* xq,
                                float* xs, int rows, int C, float eps, cudaStream_t stream) {
  if (rows == 0) return 0;
  const int grid = (rows + kRowWarps - 1) / kRowWarps;
  if (gamma != nullptr)
    ln_quant_rows_kernel<true><<<grid, kRowWarps * 32, 0, stream>>>(x, gamma, beta, xq, xs, rows,
                                                                     C, eps);
  else
    ln_quant_rows_kernel<false><<<grid, kRowWarps * 32, 0, stream>>>(x, gamma, beta, xq, xs, rows,
                                                                      C, eps);
  return static_cast<int>(cudaGetLastError());
}

// Two adjacent bf16 values (4-byte aligned) as floats, and back.
__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

}  // namespace i8
}  // namespace ullava
