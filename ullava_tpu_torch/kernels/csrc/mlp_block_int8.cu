// fused_mlp_block (w8a8, 2-D form): x + fc2(gelu(fc1(LN(x)))) with both
// products int8 x int8 -> int32, the GELU by the polynomial erf, and the
// GELU output re-quantized per row and per chunk of f_chunk columns.
//
// Replaces: ullava_tpu/ops/mlp_kernel.py:157 fused_mlp_block (a Pallas
// kernel that keeps a 1024-row tile, its [1024, C] fp32 accumulator and
// one F-chunk of both weights in VMEM, so the [T, F] intermediate never
// reaches HBM).
//
// Bound on the card: a ViT-H block at B=16 is 2 x 65536 x 1280 x 5120 x 2
// = 1.72e12 int8 operations, 0.87 ms at 1,979 TOP/s, against 0.35 GB of
// input and output (0.10 ms): operations bound it.
//
// Design: three launches. An SM's 227 KB cannot hold a row tile's
// [rows, 1280] fp32 accumulator next to the operand tiles at a row count
// that keeps the tensor cores busy, so the intermediate crosses HBM once,
// as int8 (1 byte per element, a quarter of its fp32 size).
//   1. row pass: LayerNorm + per-row int8 quantization (int8_gemm_core.cuh);
//   2. fc1 GEMM on the shared core. Its epilogue computes
//      h = gelu(acc * (xs * s1) + b1) in registers. A chunk's abs-max of a
//      row spans f_chunk / 128 column tiles, so those blocks form one
//      thread block cluster: each reduces its tile's per-row abs-max into
//      its own shared memory, the cluster synchronises, every block reads
//      its peers' maxima through distributed shared memory, and then
//      quantizes the h it still holds in registers. No fp32 h is stored.
//      It writes int8 h [rows, F] and hs [rows, F / f_chunk];
//   3. fc2 GEMM on the shared core with K cut into chunks of f_chunk: at
//      every chunk boundary the int32 partial sums are rescaled into fp32
//      accumulators, acc2 += acc * (hs[row, chunk] * s2), and the epilogue
//      adds b2 and x and rounds to bf16 once.
#include <cooperative_groups.h>

#include "gelu_poly.cuh"
#include "int8_gemm_core.cuh"

namespace cg = cooperative_groups;

namespace ullava {
namespace i8 {

struct Fc1Epi {
  using State = NoState;
  static constexpr int kMinBlocks = 2;
  const float* xs;   // [M]
  const float* s1;   // [F]
  const bf16* b1;    // [F]
  int8_t* hq;        // [M, F]
  float* hs;         // [M, n_chunks]
  int n_chunks;
  int tiles_per_chunk;  // f_chunk / BN, the cluster size

  __device__ __forceinline__ void chunk(Acc& acc, int, const Tile& t, State&) const {
    constexpr int LDQ = BN + 16;
    cg::cluster_group cluster = cg::this_cluster();
    float* s_part = reinterpret_cast<float*>(t.smem);  // [WARPS_N][BM]
    float* s_tile = s_part + WARPS_N * BM;             // [BM] this tile's row abs-max
    float* s_scale = s_tile + BM;                      // [BM] 127 / amax of the chunk
    int8_t* s_q = reinterpret_cast<int8_t*>(s_scale + BM);  // [BM][LDQ]

    float h[MI][NI][4];
    float rmax[MI][2];
    float xr[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = t.row(mi, half);
        xr[mi][half] = row < t.M ? xs[row] : 0.f;
        rmax[mi][half] = 0.f;
      }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = t.col(ni);
      const float2 w = *reinterpret_cast<const float2*>(s1 + col);
      const float2 b = load_bf16x2(b1 + col);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = gelu_poly(static_cast<float>(acc[mi][ni][e]) *
                                        (xr[mi][e >> 1] * ((e & 1) ? w.y : w.x)) +
                                    ((e & 1) ? b.y : b.x));
          h[mi][ni][e] = v;
          rmax[mi][e >> 1] = fmaxf(rmax[mi][e >> 1], fabsf(v));
        }
    }
    __syncthreads();  // every warp is done with the operand tiles
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float m = rmax[mi][half];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        if (t.tq == 0) s_part[t.wn * BM + t.lrow(mi, half)] = m;
      }
    __syncthreads();
    const int tid = threadIdx.x;
    if (tid < BM) {
      float m = s_part[tid];
#pragma unroll
      for (int w = 1; w < WARPS_N; ++w) m = fmaxf(m, s_part[w * BM + tid]);
      s_tile[tid] = m;
    }
    cluster.sync();  // every tile of the chunk has its row maxima in place
    if (tid < BM) {
      float m = 0.f;
      for (int r = 0; r < tiles_per_chunk; ++r)
        m = fmaxf(m, cluster.map_shared_rank(s_tile, r)[tid]);
      const float amax = fmaxf(m, 1e-12f);
      s_scale[tid] = 127.0f / amax;
      const int row = t.row0 + tid;
      if (cluster.block_rank() == 0 && row < t.M)
        hs[static_cast<size_t>(row) * n_chunks + blockIdx.x / tiles_per_chunk] =
            amax * (1.0f / 127.0f);
    }
    cluster.sync();  // peers have read s_tile; s_scale is visible to the block
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = t.lrow(mi, half);
        const float qs = s_scale[lr];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int q0 = __float2int_rn(h[mi][ni][half * 2] * qs);
          const int q1 = __float2int_rn(h[mi][ni][half * 2 + 1] * qs);
          *reinterpret_cast<uint16_t*>(s_q + lr * LDQ + t.lcol(ni)) =
              static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
        }
      }
    __syncthreads();
    // The int8 tile leaves as 16-byte vectors, 8 per row.
    const size_t F = static_cast<size_t>(t.N);
    for (int i = tid; i < BM * (BN / 16); i += THREADS) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      if (t.row0 + r < t.M)
        *reinterpret_cast<uint4*>(hq + (t.row0 + r) * F + t.col0 + c) =
            *reinterpret_cast<const uint4*>(s_q + r * LDQ + c);
    }
  }
  __device__ __forceinline__ void finish(const Tile&, State&) const {}
};

struct Fc2Epi {
  struct State {
    float f[MI][NI][4];
  };
  static constexpr int kMinBlocks = 1;
  const float* hs;  // [M, n_chunks]
  const float* s2;  // [C]
  const bf16* b2;   // [C]
  const bf16* x;    // [M, C] the block's input, added back
  bf16* out;        // [M, C]
  int n_chunks;

  __device__ __forceinline__ void chunk(Acc& acc, int c, const Tile& t, State& st) const {
    float hr[MI][2];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = t.row(mi, half);
        hr[mi][half] = row < t.M ? hs[static_cast<size_t>(row) * n_chunks + c] : 0.f;
      }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = t.col(ni);
      const float2 w = col < t.N ? *reinterpret_cast<const float2*>(s2 + col) : make_float2(0.f, 0.f);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st.f[mi][ni][e] +=
              static_cast<float>(acc[mi][ni][e]) * (hr[mi][e >> 1] * ((e & 1) ? w.y : w.x));
    }
  }

  __device__ __forceinline__ void finish(const Tile& t, State& st) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = t.col(ni);
      if (col >= t.N) continue;
      const float2 b = load_bf16x2(b2 + col);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = t.row(mi, half);
          if (row >= t.M) continue;
          const size_t at = static_cast<size_t>(row) * t.N + col;
          const float2 r = load_bf16x2(x + at);
          store_bf16x2(out + at, st.f[mi][ni][half * 2] + b.x + r.x,
                       st.f[mi][ni][half * 2 + 1] + b.y + r.y);
        }
    }
  }
};

}  // namespace i8
}  // namespace ullava

// x, out [rows, C] bf16; ln_s, ln_b, b2 [C] bf16; w1q int8 [F][C] (C
// contiguous), s1 [F] f32, b1 [F] bf16; w2q int8 [C][F] (F contiguous),
// s2 [C] f32. Scratch: xq [rows, C] int8, xs [rows] f32, hq [rows, F]
// int8, hs [rows, F / f_chunk] f32. f_chunk is a multiple of 128, at most
// 1024, and divides F. `stages`: bit 0 the row pass, bit 1 fc1, bit 2 fc2
// (7 = the function).
ULLAVA_EXPORT int ullava_fused_mlp_block_int8(const void* x, const void* ln_s, const void* ln_b,
                                              const void* w1q, const void* s1, const void* b1,
                                              const void* w2q, const void* s2, const void* b2,
                                              void* out, void* xq, void* xs, void* hq, void* hs,
                                              int rows, int C, int F, int f_chunk, float eps,
                                              int stages, void* stream) {
  using namespace ullava;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = F / f_chunk;
  if (stages & 1) {
    const int err = i8::launch_ln_quant_rows(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s),
        static_cast<const bf16*>(ln_b), static_cast<int8_t*>(xq), static_cast<float*>(xs), rows,
        C, eps, st);
    if (err != 0) return err;
  }
  if (stages & 2) {
    i8::Fc1Epi epi{static_cast<const float*>(xs), static_cast<const float*>(s1),
                   static_cast<const bf16*>(b1), static_cast<int8_t*>(hq),
                   static_cast<float*>(hs), n_chunks, f_chunk / i8::BN};
    const int KT = (C + i8::BK - 1) / i8::BK;
    const int err = i8::launch_gemm(static_cast<const int8_t*>(xq), C, rows,
                                    static_cast<const int8_t*>(w1q), C, F, C, KT, epi,
                                    f_chunk / i8::BN, st);
    if (err != 0) return err;
  }
  if (stages & 4) {
    i8::Fc2Epi epi{static_cast<const float*>(hs), static_cast<const float*>(s2),
                   static_cast<const bf16*>(b2), static_cast<const bf16*>(x),
                   static_cast<bf16*>(out), n_chunks};
    return i8::launch_gemm(static_cast<const int8_t*>(hq), F, rows,
                           static_cast<const int8_t*>(w2q), F, C, F, f_chunk / i8::BK, epi, 1, st);
  }
  return 0;
}
