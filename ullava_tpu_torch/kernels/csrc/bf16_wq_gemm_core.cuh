// A bf16 x int8-weight -> fp32 tensor-core GEMM core on mma.sync, beside
// int8_gemm_core.cuh, whose tile shape, Tile map and epilogue protocol it
// keeps. It now runs only the weight-only fused_ln_linear_dual (K13,
// ln_linear_wq.cu); the weight-only K10 and K12 run on the wgmma + TMA
// core, bf16_wq_gemm_sm90.cuh. This header also holds the bf16 LayerNorm
// row pass that all three weight-only kernels run first.
//
//   acc[m, n] = sum_k A[m, k] * float(B[k, n])
// A is row-major bf16 [M, K] (row stride lda elements). B is an int8
// weight as the port stores it: column-major, Bt[n, k] with K contiguous
// per output column (row stride ldb bytes). Every int8 value is a bf16
// value, so widening B to bf16 is exact and the products are the TPU
// kernel's bf16 x bf16 products with fp32 accumulation.
//
// A block of 256 threads owns a 128 x 128 output tile: 8 warps laid out
// 2 (M) x 4 (N), each holding a 64 x 32 tile as 4 x 4 fp32 accumulators
// of mma.sync.m16n8k16 (64 registers). K is walked in tiles of 64 values
// through a 3-stage cp.async ring: the A tile as bf16 (rows padded to 160
// bytes), the B tile as int8 (rows padded to 80 bytes), so the weight
// crosses HBM and shared memory at one byte a value. B is widened at the
// fragment load.
//
// The fragments take each 16-deep k slice in a permuted order: the mma's
// logical k slots {2t, 2t+1, 2t+8, 2t+9} of lane quad t hold the physical
// k {4t, .., 4t+3}. A dot product does not depend on the order of its
// terms, so A and B only have to agree: a lane then reads 4 contiguous
// int8 of B (one 32-bit load, two packed bf16 pairs after widening) and 4
// contiguous bf16 of A (one 64-bit load per row half), both free of bank
// conflicts at these row strides, with no ldmatrix.
//
// Rows past M, columns past N and k past K are zero-filled by 0-byte
// copies, so any M, any N that is a multiple of 8 and any K that is a
// multiple of 16 is taken; row strides and base pointers must be
// multiples of 16 bytes.
//
// ULLAVA_MUTANT_WQ_UNSIGNED builds a deliberate bug (the int8 weight
// widened as unsigned bytes) that only `chip_smoke.py` compiles, to show
// that the weight-only kernels' gates catch it.
#pragma once

#include "int8_gemm_core.cuh"

namespace ullava {
namespace wq {

using i8::cp_async_commit;
using i8::cp_async_wait_group;
using i8::load_bf16x2;
using i8::smem_u32;
using i8::store_bf16x2;
using i8::Tile;

constexpr int BM = 128, BN = 128, BK = 64;  // BK in k values
constexpr int LDA = BK * 2 + 32;            // A row stride in bytes (= 32 mod 128)
constexpr int LDB = BK + 16;                // B row stride in bytes (= 80 mod 128)
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int WARPS_N = 4;
constexpr int WM = 64, WN = 32;
constexpr int MI = WM / 16, NI = WN / 8;
constexpr int A_STAGE = BM * LDA;                      // 20480
constexpr int B_STAGE = BN * LDB;                      // 10240
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE);  // 92160
static_assert(BM == i8::BM && BN == i8::BN && WM == i8::WM && WN == i8::WN &&
                  WARPS_N == i8::WARPS_N,
              "the Tile map of int8_gemm_core.cuh is reused");

using Acc = float[MI][NI][4];

// Two int8 values -> a packed bf16 pair (lower k in the low half).
__device__ __forceinline__ uint32_t widen2(uint32_t w, int shift) {
#ifdef ULLAVA_MUTANT_WQ_UNSIGNED
  const float lo = static_cast<float>((w >> shift) & 0xffu);
  const float hi = static_cast<float>((w >> (shift + 8)) & 0xffu);
#else
  const float lo = static_cast<float>(static_cast<int8_t>(w >> shift));
  const float hi = static_cast<float>(static_cast<int8_t>(w >> (shift + 8)));
#endif
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // exact
  return *reinterpret_cast<const uint32_t*>(&v);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}

template <class Epi>
__global__ void __launch_bounds__(THREADS, Epi::kMinBlocks)
    gemm_kernel(const bf16* __restrict__ A, int lda, int M, const int8_t* __restrict__ Bt,
                int ldb, int N, int K, const Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* sA = smem;                     // [STAGES][BM][LDA]
  unsigned char* sB = smem + STAGES * A_STAGE;  // [STAGES][BN][LDB]

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
    const int k0 = kt * BK;
#pragma unroll
    for (int it = 0; it < BM * (BK / 8) / THREADS; ++it) {  // 8 bf16 a vector
      const int i = tid + it * THREADS;
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = t.row0 + r < M && k0 + c < K;
      const bf16* g = ok ? A + static_cast<size_t>(t.row0 + r) * lda + k0 + c : A;
      cp_async16(sA + stage * A_STAGE + r * LDA + c * 2, g, ok);
    }
#pragma unroll
    for (int it = 0; it < BN * (BK / 16) / THREADS; ++it) {  // 16 int8 a vector
      const int i = tid + it * THREADS;
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const bool ok = t.col0 + r < N && k0 + c < K;
      const int8_t* g = ok ? Bt + static_cast<size_t>(t.col0 + r) * ldb + k0 + c : Bt;
      cp_async16(sB + stage * B_STAGE + r * LDB + c, g, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }

  Acc acc;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  // This lane's rows: A rows g and g + 8 of each 16-row tile, B row
  // (output column) g of each 8-column tile, at byte 4 t of the slice.
  const int a_off = (t.wm * WM + t.g) * LDA + t.tq * 8;
  const int b_off = (t.wn * WN + t.g) * LDB + t.tq * 4;

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait_group<STAGES - 2>();  // tile kt has landed
    __syncthreads();                    // and the stage computed at kt - 1 is free
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned char* tA = sA + (kt % STAGES) * A_STAGE + a_off;
    const unsigned char* tB = sB + (kt % STAGES) * B_STAGE + b_off;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const uint2 lo = *reinterpret_cast<const uint2*>(tA + mi * 16 * LDA + kk * 32);
        const uint2 hi = *reinterpret_cast<const uint2*>(tA + (mi * 16 + 8) * LDA + kk * 32);
        af[mi][0] = lo.x;  // row g,     logical k 2t, 2t+1   (physical 4t, 4t+1)
        af[mi][1] = hi.x;  // row g + 8
        af[mi][2] = lo.y;  // row g,     logical k 2t+8, 2t+9 (physical 4t+2, 4t+3)
        af[mi][3] = hi.y;  // row g + 8
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(tB + ni * 8 * LDB + kk * 16);
        bfr[ni][0] = widen2(w, 0);
        bfr[ni][1] = widen2(w, 16);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait_group<0>();
  epi.finish(acc, t);
}

// Launches the GEMM with `epi` on `stream`.
template <class Epi>
int launch_gemm(const bf16* A, int lda, int M, const int8_t* Bt, int ldb, int N, int K,
                const Epi& epi, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_kernel<Epi><<<grid, THREADS, SMEM_BYTES, stream>>>(A, lda, M, Bt, ldb, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

// y = acc * w_scale[col] + bias[col], in that order in fp32, one rounding
// to bf16: the TPU kernel's weight-only epilogue. `Bias` is bf16 (the qkv
// bias) or float (the composite bias weights'). With rows2 < T, of every
// T rows only the leading rows2 are stored, packed to [M / T, rows2, N]
// (the second output of fused_ln_linear_dual).
template <class Bias>
struct LinearEpi {
  static constexpr int kMinBlocks = 2;
  const float* ws;        // [N] per-output-channel weight scale
  const Bias* bias;       // [N]
  bf16* out;
  int T, rows2;           // T = rows2 = M: every row, [M, N]

  __device__ __forceinline__ float2 bias2(int col) const {
    if constexpr (sizeof(Bias) == 4) {
      return *reinterpret_cast<const float2*>(bias + col);
    } else {
      return load_bf16x2(reinterpret_cast<const bf16*>(bias) + col);
    }
  }

  __device__ __forceinline__ void finish(const Acc& acc, const Tile& t) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = t.col(ni);
      if (col >= t.N) continue;
      const float2 w = *reinterpret_cast<const float2*>(ws + col);
      const float2 b = bias2(col);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = t.row(mi, half);
          if (row >= t.M || row % T >= rows2) continue;
          const float y0 = acc[mi][ni][half * 2] * w.x + b.x;
          const float y1 = acc[mi][ni][half * 2 + 1] * w.y + b.y;
          const size_t orow = static_cast<size_t>(row / T) * rows2 + row % T;
          store_bf16x2(out + orow * t.N + col, y0, y1);
        }
      }
    }
  }
};

// ---------------------------------------------------------------------
// Row pass: the int8 core's LayerNorm (`i8::load_row`, fp32, one warp per
// row held in registers, C <= 2048), the result rounded to bf16.
// ---------------------------------------------------------------------
using i8::kRowMaxVec;
using i8::kRowWarps;

__global__ void __launch_bounds__(kRowWarps * 32)
    ln_rows_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma,
                        const bf16* __restrict__ beta, bf16* __restrict__ xn, int rows, int C,
                        float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  float v[kRowMaxVec][8];
  i8::load_row<true>(v, x + static_cast<size_t>(row) * C, gamma, beta, lane, C, eps);
  bf16* orow = xn + static_cast<size_t>(row) * C;
#pragma unroll
  for (int i = 0; i < kRowMaxVec; ++i) {
    const int vec = lane + i * 32;
    if (vec < C / 8) store_bf16x8(orow + vec * 8, v[i]);
  }
}

// x [rows, C] bf16 -> xn [rows, C] bf16 = LN(x).
inline int launch_ln_rows_bf16(const bf16* x, const bf16* gamma, const bf16* beta, bf16* xn,
                               int rows, int C, float eps, cudaStream_t stream) {
  if (rows == 0) return 0;
  const int grid = (rows + kRowWarps - 1) / kRowWarps;
  ln_rows_bf16_kernel<<<grid, kRowWarps * 32, 0, stream>>>(x, gamma, beta, xn, rows, C, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wq
}  // namespace ullava
