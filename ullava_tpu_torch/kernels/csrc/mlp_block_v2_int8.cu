// fused_mlp_block_v2 (K23, w8a8, 2-D form): the chunk-pipelined int8 MLP,
// x + fc2(gelu(fc1(LN(x)))). The same function as fused_mlp_block's w8a8
// form (mlp_block_int8.cu), and bit for bit its output at the same f_chunk:
// the LN'd row quantized once, fc1 int8 x int8, the polynomial-erf GELU,
// its output re-quantized per row and per chunk of f_chunk columns, fc2
// int8 x int8 with each chunk's int32 sums rescaled by hs * s2 into an fp32
// sum in chunk order, then + b2 + x and one bf16 rounding.
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
//     (int8_gemm_core.cuh), xq [T, C] int8 and xs [T] f32;
//  2. one kernel for the rest. A thread block cluster of 8 blocks owns 64
//     rows. Block r computes columns [r, r + 1) * f_chunk / 8 of every
//     chunk's fc1 and output columns [r, r + 1) * C / 8 of fc2: no work is
//     repeated, and the [64, C] fp32 accumulator is split 8 ways (40
//     registers a thread at C = 1280). Step s of n_chunks + 1:
//       a. fc1 of chunk s (mma.sync int8, int32 sums in registers);
//       b. the re-quantization of chunk s - 1: the chunk's row abs-max is
//          the max of the 8 blocks' partial maxima, read through
//          distributed shared memory; the GELU values held in registers
//          since step s - 1 are quantized into this block's int8 slice,
//          hbuf[(s - 1) % 2];
//       c. the GELU of chunk s and this block's partial row abs-max of it,
//          into amax[s % 2];
//       d. one cluster barrier;
//       e. fc2 of chunk s - 1: the 8 slices of hbuf[(s - 1) % 2] are copied
//          from the cluster into this block's shared memory (sH), and the
//          int32 sums of the chunk are rescaled into the fp32 accumulator.
//     After the last step: + b2 + x and one bf16 rounding.
//   The GELU intermediate lives in registers and shared memory only.
//   Hazards, each covered by the one cluster barrier a step:
//     - hbuf[b] is written at step s (b) and read by the peers at step s
//       (e): the barrier of step s lies between;
//     - hbuf[b] is written again at step s + 2 (b), after the barrier of
//       step s + 1, which every peer reaches only after its step-s reads;
//     - amax[b] is written at step s (c), read at step s + 1 (b) and
//       written again at step s + 2 (c), after the barrier of step s + 1.
//   A last cluster barrier keeps each block's shared memory alive until
//   its peers have copied the last chunk.
//
// `stages`: bit 0 the row pass, bit 1 fc1 with the GELU and the
// re-quantization (a-c), bit 2 fc2 and the output (e), so each can be timed
// alone (6 = the main kernel, 7 = the function).
//
// Deliberate bugs for the correctness gate (chip_smoke.py), each built
// only into a copy of this source under its define:
//   ULLAVA_MUTANT_V2_ROW_AMAX    one abs-max per whole row (a first pass of
//                                fc1 and the GELU over every chunk);
//   ULLAVA_MUTANT_V2_WRONG_BUFFER fc2 of chunk s - 1 reads hbuf[s % 2],
//                                the buffer the next chunk is written to;
//   ULLAVA_MUTANT_V2_NO_FC1_BIAS fc1's bias dropped.
//
// Not yet: wgmma, TMA multicast of the weight tiles, warp specialisation.
// The 8 warps of a block run the steps in lockstep, so the tensor-core
// work of a and e and the FMA work of b and c do not overlap inside an SM.
#include <cooperative_groups.h>

#include "gelu_poly.cuh"
#include "int8_gemm_core.cuh"

namespace cg = cooperative_groups;

namespace ullava {
namespace i8 {
namespace v2 {

constexpr int CL = 8;      // blocks a cluster
constexpr int ROWS = 64;   // rows a cluster
constexpr int NTHR = 256;  // 8 warps
constexpr int LDK = LDS;   // operand ring row stride in bytes (BK + 16)

// SN: fc1 columns a block (f_chunk / 8); NC2: fc2 output columns a block
// (C / 8).
template <int SN, int NC2>
struct Layout {
  // fc1: warps 2 (M) x 4 (N), a warp tile of 32 x SN / 4.
  static constexpr int MI1 = 2, WN1 = SN / 4, NI1 = WN1 / 8;
  // fc2: warps 4 (M) x 2 (N), a warp tile of 16 x NC2 / 2.
  static constexpr int WN2 = NC2 / 2, NI2 = WN2 / 8;
  static constexpr int FC = SN * CL;   // f_chunk
  static constexpr int LDQ = SN + 16;  // hbuf row stride
  static constexpr int LDH = FC + 16;  // sH row stride
  static constexpr int O_RING2 = STAGES * (ROWS + SN) * LDK;
  static constexpr int O_SH = O_RING2 + STAGES * NC2 * LDK;
  static constexpr int O_HBUF = O_SH + ROWS * LDH;
  static constexpr int HBUF = ROWS * LDQ;
  static constexpr int O_F32 = O_HBUF + 2 * HBUF;
  // floats: part [4][64], amax [2][64], qs, hs, xs, rowpart [64] each
  static constexpr int BYTES = O_F32 + 10 * ROWS * 4;
  static_assert(NI1 % 2 == 0 && NI2 % 2 == 0, "ldmatrix.x4 loads two n8 tiles");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// Starts copying rows [row0, row0 + nrows) x bytes [k0, k0 + BK) of a
// row-major int8 matrix (row stride ld) into a [nrows][LDK] tile; rows at
// or past `valid` are zero-filled.
__device__ __forceinline__ void load_rows_async(int8_t* dst, const int8_t* src, int ld, int row0,
                                                int nrows, int valid, int k0, int tid) {
  constexpr int VPR = BK / 16;
  for (int i = tid; i < nrows * VPR; i += NTHR) {
    const int r = i / VPR, c = (i % VPR) * 16;
    const bool ok = row0 + r < valid;
    const int8_t* g = ok ? src + static_cast<size_t>(row0 + r) * ld + k0 + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * LDK + c)),
                 "l"(g), "r"(ok ? 16 : 0));
  }
}

template <int SN, int NC2>
struct Block {
  using L = Layout<SN, NC2>;
  static constexpr int C = NC2 * CL;

  const int8_t* xq;  // [M, C]
  const int8_t* w1;  // [F][C]
  const float* s1;   // [F]
  const bf16* b1;    // [F]
  const int8_t* w2;  // [C][F]
  const float* s2;   // [C]
  const bf16* b2;    // [C]
  const bf16* x;     // [M, C]
  bf16* out;         // [M, C]
  int M, F;

  unsigned char* smem;
  int tid, lane, warp, g, tq, row0, rank;

  __device__ __forceinline__ int8_t* ring1() const { return reinterpret_cast<int8_t*>(smem); }
  __device__ __forceinline__ int8_t* ring2() const {
    return reinterpret_cast<int8_t*>(smem + L::O_RING2);
  }
  __device__ __forceinline__ int8_t* sH() const {
    return reinterpret_cast<int8_t*>(smem + L::O_SH);
  }
  __device__ __forceinline__ int8_t* hbuf(int b) const {
    return reinterpret_cast<int8_t*>(smem + L::O_HBUF + b * L::HBUF);
  }
  __device__ __forceinline__ float* f32() const {
    return reinterpret_cast<float*>(smem + L::O_F32);
  }
  __device__ __forceinline__ float* s_part() const { return f32(); }  // [4][ROWS]
  __device__ __forceinline__ float* s_amax(int b) const { return f32() + (4 + b) * ROWS; }
  __device__ __forceinline__ float* s_qs() const { return f32() + 6 * ROWS; }
  __device__ __forceinline__ float* s_hs() const { return f32() + 7 * ROWS; }
  __device__ __forceinline__ float* s_xs() const { return f32() + 8 * ROWS; }
  __device__ __forceinline__ float* s_rowpart() const { return f32() + 9 * ROWS; }

  // fc1 warp position and the local row of accumulator row (mi, half).
  __device__ __forceinline__ int wm1() const { return warp / 4; }
  __device__ __forceinline__ int wn1() const { return warp % 4; }
  __device__ __forceinline__ int lrow1(int mi, int half) const {
    return wm1() * 32 + mi * 16 + g + half * 8;
  }
  __device__ __forceinline__ int lcol1(int ni) const { return wn1() * L::WN1 + ni * 8 + tq * 2; }

  // a: the int32 fc1 sums of this block's SN columns of chunk c.
  __device__ __forceinline__ void fc1(int (&acc)[L::MI1][L::NI1][4], int c) const {
    int8_t* sA = ring1();                     // [STAGES][ROWS][LDK]
    int8_t* sB = sA + STAGES * ROWS * LDK;    // [STAGES][SN][LDK]
    const int n0 = c * L::FC + rank * SN;
    constexpr int KT = C / BK;
    __syncthreads();  // every warp is done with the ring's last use
    auto load = [&](int kt, int st) {
      load_rows_async(sA + st * ROWS * LDK, xq, C, row0, ROWS, M, kt * BK, tid);
      load_rows_async(sB + st * SN * LDK, w1, C, n0, SN, F, kt * BK, tid);
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      load(st, st);
      cp_async_commit();
    }
#pragma unroll
    for (int mi = 0; mi < L::MI1; ++mi)
#pragma unroll
      for (int ni = 0; ni < L::NI1; ++ni)
        acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0;
    const int a_off = (wm1() * 32 + (lane & 15)) * LDK + (lane >> 4) * 16;
    const int b_off =
        (wn1() * L::WN1 + (lane & 7) + ((lane >> 4) << 3)) * LDK + ((lane >> 3) & 1) * 16;
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait_group<STAGES - 2>();
      __syncthreads();
      if (kt + STAGES - 1 < KT) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
      cp_async_commit();
      const int8_t* tA = sA + (kt % STAGES) * ROWS * LDK + a_off;
      const int8_t* tB = sB + (kt % STAGES) * SN * LDK + b_off;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        uint32_t af[L::MI1][4], bfr[L::NI1 / 2][4];
#pragma unroll
        for (int mi = 0; mi < L::MI1; ++mi) ldmatrix_x4(af[mi], tA + mi * 16 * LDK + kk * 32);
#pragma unroll
        for (int np = 0; np < L::NI1 / 2; ++np) ldmatrix_x4(bfr[np], tB + np * 16 * LDK + kk * 32);
#pragma unroll
        for (int mi = 0; mi < L::MI1; ++mi)
#pragma unroll
          for (int ni = 0; ni < L::NI1; ++ni)
            mma_s8(acc[mi][ni], af[mi], bfr[ni / 2][(ni & 1) * 2], bfr[ni / 2][(ni & 1) * 2 + 1]);
      }
    }
  }

  // c: h = gelu(acc * (xs * s1) + b1), K12's expression, and this thread's
  // row abs-maxima of it folded into rmax.
  __device__ __forceinline__ void gelu(const int (&acc)[L::MI1][L::NI1][4], int c,
                                       float (&h)[L::MI1][L::NI1][4],
                                       float (&rmax)[L::MI1][2]) const {
    float xr[L::MI1][2];
#pragma unroll
    for (int mi = 0; mi < L::MI1; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) xr[mi][half] = s_xs()[lrow1(mi, half)];
    const int n0 = c * L::FC + rank * SN;
#pragma unroll
    for (int ni = 0; ni < L::NI1; ++ni) {
      const int col = n0 + lcol1(ni);
      const float2 w = *reinterpret_cast<const float2*>(s1 + col);
#ifdef ULLAVA_MUTANT_V2_NO_FC1_BIAS
      const float2 b = make_float2(0.f, 0.f);
#else
      const float2 b = load_bf16x2(b1 + col);
#endif
#pragma unroll
      for (int mi = 0; mi < L::MI1; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = gelu_poly(static_cast<float>(acc[mi][ni][e]) *
                                        (xr[mi][e >> 1] * ((e & 1) ? w.y : w.x)) +
                                    ((e & 1) ? b.y : b.x));
          h[mi][ni][e] = v;
          rmax[mi][e >> 1] = fmaxf(rmax[mi][e >> 1], fabsf(v));
        }
    }
  }

  // This block's row abs-maxima over its SN columns: reduced over the
  // quad, then over the 4 column warps into dst[ROWS].
  __device__ __forceinline__ void reduce_rows(const float (&rmax)[L::MI1][2], float* dst) const {
#pragma unroll
    for (int mi = 0; mi < L::MI1; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float m = rmax[mi][half];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (tq == 0) s_part()[wn1() * ROWS + lrow1(mi, half)] = m;
      }
    __syncthreads();
    if (tid < ROWS) {
      float m = s_part()[tid];
#pragma unroll
      for (int w = 1; w < 4; ++w) m = fmaxf(m, s_part()[w * ROWS + tid]);
      dst[tid] = m;
    }
  }

  // b: the chunk's scales from the cluster's partial maxima in amax[b],
  // and h quantized into hbuf[b].
  __device__ __forceinline__ void requant(const float (&h)[L::MI1][L::NI1][4], int b,
                                          cg::cluster_group& cluster) const {
    __syncthreads();  // the last chunk's fc2 has read s_hs (no fc1 between at the last step)
    if (tid < ROWS) {
      float m = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r) m = fmaxf(m, cluster.map_shared_rank(s_amax(b), r)[tid]);
      const float amax = fmaxf(m, 1e-12f);
      s_qs()[tid] = 127.0f / amax;
      s_hs()[tid] = amax * (1.0f / 127.0f);
    }
    __syncthreads();
    int8_t* q = hbuf(b);
#pragma unroll
    for (int mi = 0; mi < L::MI1; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = lrow1(mi, half);
        const float qs = s_qs()[lr];
#pragma unroll
        for (int ni = 0; ni < L::NI1; ++ni) {
          const int q0 = __float2int_rn(h[mi][ni][half * 2] * qs);
          const int q1 = __float2int_rn(h[mi][ni][half * 2 + 1] * qs);
          *reinterpret_cast<uint16_t*>(q + lr * L::LDQ + lcol1(ni)) =
              static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
        }
      }
  }

  // e: fc2 of chunk c on the cluster's hbuf[b], rescaled into f.
  __device__ __forceinline__ void fc2(float (&f)[L::NI2][4], int c, int b,
                                      cg::cluster_group& cluster) const {
    int8_t* sB = ring2();  // [STAGES][NC2][LDK]
    int8_t* h = sH();      // [ROWS][LDH]
    const int k0 = c * L::FC, n0 = rank * NC2;
    constexpr int KT = L::FC / BK;
    __syncthreads();  // every warp is done with the ring and sH of the last chunk
    auto load = [&](int kt, int st) {
      load_rows_async(sB + st * NC2 * LDK, w2, F, n0, NC2, C, k0 + kt * BK, tid);
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      load(st, st);
      cp_async_commit();
    }
    // The chunk's [ROWS, FC] int8 rows: SN columns from each block.
    constexpr int VPR = L::FC / 16, VPS = SN / 16;
    for (int i = tid; i < ROWS * VPR; i += NTHR) {
      const int r = i / VPR, v = i % VPR;
      const int8_t* src = cluster.map_shared_rank(hbuf(b), v / VPS) + r * L::LDQ + (v % VPS) * 16;
      *reinterpret_cast<uint4*>(h + r * L::LDH + v * 16) = *reinterpret_cast<const uint4*>(src);
    }
    const int wm2 = warp / 2, wn2 = warp % 2;
    int acc[L::NI2][4];
#pragma unroll
    for (int ni = 0; ni < L::NI2; ++ni) acc[ni][0] = acc[ni][1] = acc[ni][2] = acc[ni][3] = 0;
    const int a_off = (wm2 * 16 + (lane & 15)) * L::LDH + (lane >> 4) * 16;
    const int b_off =
        (wn2 * L::WN2 + (lane & 7) + ((lane >> 4) << 3)) * LDK + ((lane >> 3) & 1) * 16;
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait_group<STAGES - 2>();
      __syncthreads();  // also makes sH visible at kt = 0
      if (kt + STAGES - 1 < KT) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
      cp_async_commit();
      const int8_t* tA = h + a_off + kt * BK;
      const int8_t* tB = sB + (kt % STAGES) * NC2 * LDK + b_off;
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        uint32_t af[4], bfr[L::NI2 / 2][4];
        ldmatrix_x4(af, tA + kk * 32);
#pragma unroll
        for (int np = 0; np < L::NI2 / 2; ++np) ldmatrix_x4(bfr[np], tB + np * 16 * LDK + kk * 32);
#pragma unroll
        for (int ni = 0; ni < L::NI2; ++ni)
          mma_s8(acc[ni], af, bfr[ni / 2][(ni & 1) * 2], bfr[ni / 2][(ni & 1) * 2 + 1]);
      }
    }
    // acc2 += acc * (hs * s2): K12's fc2 rescale.
    float hr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) hr[half] = s_hs()[wm2 * 16 + g + half * 8];
#pragma unroll
    for (int ni = 0; ni < L::NI2; ++ni) {
      const int col = n0 + wn2 * L::WN2 + ni * 8 + tq * 2;
      const float2 w = *reinterpret_cast<const float2*>(s2 + col);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[ni][e] += static_cast<float>(acc[ni][e]) * (hr[e >> 1] * ((e & 1) ? w.y : w.x));
    }
  }

  // out = f + b2 + x, rounded once; rows past M are not stored.
  __device__ __forceinline__ void store(const float (&f)[L::NI2][4]) const {
    const int wm2 = warp / 2, wn2 = warp % 2;
#pragma unroll
    for (int ni = 0; ni < L::NI2; ++ni) {
      const int col = rank * NC2 + wn2 * L::WN2 + ni * 8 + tq * 2;
      const float2 b = load_bf16x2(b2 + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + wm2 * 16 + g + half * 8;
        if (row >= M) continue;
        const size_t at = static_cast<size_t>(row) * C + col;
        const float2 r = load_bf16x2(x + at);
        store_bf16x2(out + at, f[ni][half * 2] + b.x + r.x, f[ni][half * 2 + 1] + b.y + r.y);
      }
    }
  }
};

template <int SN, int NC2>
__global__ void __launch_bounds__(NTHR, 1)
    mlp_v2_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ w1, const float* __restrict__ s1,
                  const bf16* __restrict__ b1, const int8_t* __restrict__ w2,
                  const float* __restrict__ s2, const bf16* __restrict__ b2,
                  const bf16* __restrict__ x, bf16* __restrict__ out, int M, int F, int stages) {
  using L = Layout<SN, NC2>;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  Block<SN, NC2> blk{xq, w1, s1, b1, w2, s2, b2, x, out, M, F};
  blk.smem = smem;
  blk.tid = threadIdx.x;
  blk.lane = threadIdx.x % 32;
  blk.warp = threadIdx.x / 32;
  blk.g = blk.lane / 4;
  blk.tq = blk.lane % 4;
  blk.row0 = (blockIdx.x / CL) * ROWS;
  blk.rank = static_cast<int>(cluster.block_rank());
  const bool do_fc1 = stages & 2, do_fc2 = stages & 4;
  const int n = F / L::FC;

  if (blk.tid < ROWS) {
    const int row = blk.row0 + blk.tid;
    blk.s_xs()[blk.tid] = row < M ? xs[row] : 0.f;
  }  // published by fc1's first barrier

  int acc1[L::MI1][L::NI1][4];
  float h[L::MI1][L::NI1][4];
  float f[L::NI2][4];
#pragma unroll
  for (int ni = 0; ni < L::NI2; ++ni) f[ni][0] = f[ni][1] = f[ni][2] = f[ni][3] = 0.f;

#ifdef ULLAVA_MUTANT_V2_ROW_AMAX
  if (do_fc1) {
    float rmax[L::MI1][2] = {};
    for (int c = 0; c < n; ++c) {
      blk.fc1(acc1, c);
      blk.gelu(acc1, c, h, rmax);
    }
    blk.reduce_rows(rmax, blk.s_rowpart());
  }
#endif

  for (int s = 0; s <= n; ++s) {
    if (do_fc1) {
      if (s < n) blk.fc1(acc1, s);                         // a
      if (s > 0) blk.requant(h, (s - 1) % 2, cluster);     // b
      if (s < n) {                                         // c
        float rmax[L::MI1][2] = {};
        blk.gelu(acc1, s, h, rmax);
        blk.reduce_rows(rmax, blk.s_amax(s % 2));
#ifdef ULLAVA_MUTANT_V2_ROW_AMAX
        if (blk.tid < ROWS) blk.s_amax(s % 2)[blk.tid] = blk.s_rowpart()[blk.tid];
#endif
      }
    }
    cluster.sync();                                        // d
#ifdef ULLAVA_MUTANT_V2_WRONG_BUFFER
    if (do_fc2 && s > 0) blk.fc2(f, s - 1, s % 2, cluster);
#else
    if (do_fc2 && s > 0) blk.fc2(f, s - 1, (s - 1) % 2, cluster);  // e
#endif
  }
  if (do_fc2) blk.store(f);
  cluster.sync();  // the peers have copied this block's last slice
}

template <int SN, int NC2>
int launch_v2(const int8_t* xq, const float* xs, const int8_t* w1, const float* s1, const bf16* b1,
              const int8_t* w2, const float* s2, const bf16* b2, const bf16* x, bf16* out, int M,
              int F, int stages, cudaStream_t stream) {
  using L = Layout<SN, NC2>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_v2_kernel<SN, NC2>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (M == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ((M + ROWS - 1) / ROWS));
  cfg.blockDim = dim3(NTHR);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, mlp_v2_kernel<SN, NC2>, xq, xs, w1, s1, b1, w2,
                                             s2, b2, x, out, M, F, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace v2
}  // namespace i8
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
  constexpr int kC = 1280, kNC2 = kC / i8::v2::CL;
  if (C != kC || f_chunk <= 0 || F % f_chunk) return static_cast<int>(cudaErrorInvalidValue);
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
      return args(i8::v2::launch_v2<64, kNC2>);
    case 1024:
      return args(i8::v2::launch_v2<128, kNC2>);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
