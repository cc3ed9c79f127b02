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
//   1. row pass: LayerNorm + per-row int8 quantization (ln_quant_rows.cuh);
//   2. fc1 on the wgmma + TMA int8 core (int8_gemm_sm90.cuh). Its epilogue
//      computes h = gelu(acc * (xs * s1) + b1) in fp32, in the accumulator
//      registers. A chunk's abs-max of a row spans f_chunk / 128
//      column tiles, so those blocks form one thread block cluster: each
//      reduces its tile's per-row abs-max over the quad that holds the row,
//      into its own shared memory, the cluster synchronises, every block
//      reads its peers' maxima through distributed shared memory, and then
//      quantizes the h it still holds in registers (127 / amax by a true
//      division, rounded half to even). No fp32 h is stored. It writes int8
//      h [rows, F] (staged in shared memory, stored as 16-byte vectors) and
//      hs [rows, F / f_chunk];
//   3. fc2 on the same core, one block an SM, with K cut into chunks of
//      f_chunk: at every chunk boundary the int32 sums are folded into fp32
//      accumulators, acc2 += acc * (hs[row, chunk] * s2), chunk 0 first
//      (each chunk's hs loaded during the chunk before), and the epilogue
//      adds b2 and x and rounds to bf16 once: the fp32 operations and their
//      order are the ones of the chunk-pipelined MLP (K23), whose bf16
//      output must stay bit-equal to this one.
// The 1024-row corner class gives fc2 only 80 tiles of 128 x 128 for 132
// SMs; the core has no split of K to fill the card there.
//
// Deliberate bugs for the correctness gate (chip_smoke.py), each built
// only into a copy of this source under its define:
//   ULLAVA_MUTANT_MLP_TILE_AMAX        fc1 quantizes by its own tile's row
//                                      abs-max, without the cluster's;
//   ULLAVA_MUTANT_MLP_NEXT_CHUNK_SCALE fc2 scales a chunk's sums by the
//                                      next chunk's hs.
#include "gelu_poly.cuh"
#include "ln_quant_rows.cuh"
#include "int8_gemm_sm90.cuh"

namespace ullava {
namespace i8_sm90 {

struct Fc1Epi {
  struct State {};
  static constexpr int kClusterSyncs = 2;
  static constexpr int LDQ = BN + 16;  // staged int8 tile row stride, bytes
  // s_tile [BM] this tile's row abs-max, s_scale [BM] 127 / amax of the
  // chunk; the quantized tile [BM][LDQ] is staged on the ring.
  static constexpr int kScratchBytes = 2 * BM * 4;
  const float* xs;   // [M]
  const float* s1;   // [F]
  const bf16* b1;    // [F]
  int8_t* hq;        // [M, F]
  float* hs;         // [M, n_chunks]
  int n_chunks;
  int tiles_per_chunk;  // f_chunk / BN, the cluster size

  __device__ __forceinline__ void begin(const Tile&, State&) const {}

  // h = gelu(acc * (xs * s1) + b1) replaces the int32 sums in place (as
  // fp32 bits), quantized once the chunk's row abs-max is known.
  __device__ __forceinline__ void chunk(uint32_t (&acc)[64], int, const Tile& t, State&) const {
    float* s_tile = reinterpret_cast<float*>(t.scratch);
    float* s_scale = s_tile + BM;
    int8_t* s_q = reinterpret_cast<int8_t*>(t.ring);

    float xr[2], rmax[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) xr[r] = t.row(r) < t.M ? xs[t.row(r)] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.col(j);
      const float2 w = *reinterpret_cast<const float2*>(s1 + col);
      const float2 b = load_bf16x2(b1 + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, r = e >> 1;
        const float v = i8::gelu_poly(static_cast<float>(static_cast<int>(acc[i])) *
                                          (xr[r] * ((e & 1) ? w.y : w.x)) +
                                      ((e & 1) ? b.y : b.x));
        acc[i] = __float_as_uint(v);
        rmax[r] = fmaxf(rmax[r], fabsf(v));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = sm90::quad_max(rmax[r]);  // the quad holds the row's 128 columns
      if (t.tq == 0) s_tile[t.lrow(r)] = m;
    }
    // Every tile of the chunk has its row maxima in place; every product of
    // the cluster is done, so the ring is free.
    cluster_sync();
    if (t.ct < BM) {
#ifdef ULLAVA_MUTANT_MLP_TILE_AMAX
      const float m = s_tile[t.ct];
#else
      float m = 0.f;
      for (int r = 0; r < tiles_per_chunk; ++r) m = fmaxf(m, ld_peer(s_tile + t.ct, r));
#endif
      const float amax = fmaxf(m, 1e-12f);
      s_scale[t.ct] = 127.0f / amax;
      const int row = t.row0 + t.ct;
      if (cluster_rank() == 0 && row < t.M)
        hs[static_cast<size_t>(row) * n_chunks + blockIdx.x / tiles_per_chunk] =
            amax * (1.0f / 127.0f);
    }
    cluster_sync();  // peers have read s_tile; s_scale is visible to the block
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = t.lrow(r);
      const float qs = s_scale[lr];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int q0 = __float2int_rn(__uint_as_float(acc[4 * j + 2 * r]) * qs);
        const int q1 = __float2int_rn(__uint_as_float(acc[4 * j + 2 * r + 1]) * qs);
        *reinterpret_cast<uint16_t*>(s_q + lr * LDQ + t.lcol(j)) =
            static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    }
    consumer_sync();
    // The int8 tile leaves as 16-byte vectors, 8 a row.
    const size_t F = static_cast<size_t>(t.N);
    for (int i = t.ct; i < BM * (BN / 16); i += 256) {
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
    float f[64];     // the fp32 sum of the folded chunks
    float2 w[16];    // s2 of the thread's 16 column pairs
    float hr[2];     // hs of its two rows for the next chunk to fold
  };
  static constexpr int kClusterSyncs = 0;
  static constexpr int kScratchBytes = 0;
  const float* hs;  // [M, n_chunks]
  const float* s2;  // [C]
  const bf16* b2;   // [C]
  const bf16* x;    // [M, C] the block's input, added back
  bf16* out;        // [M, C]
  int n_chunks;

  // The chunk of hs that scales chunk c's sums.
  __device__ __forceinline__ int scale_chunk(int c) const {
#ifdef ULLAVA_MUTANT_MLP_NEXT_CHUNK_SCALE
    return (c + 1) % n_chunks;
#else
    return c;
#endif
  }

  __device__ __forceinline__ void load_hr(const Tile& t, State& st, int c) const {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      st.hr[r] = t.row(r) < t.M ? hs[static_cast<size_t>(t.row(r)) * n_chunks + scale_chunk(c)]
                                : 0.f;
  }

  __device__ __forceinline__ void begin(const Tile& t, State& st) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.col(j);
      st.w[j] = col < t.N ? *reinterpret_cast<const float2*>(s2 + col) : make_float2(0.f, 0.f);
    }
    load_hr(t, st, 0);
  }

  __device__ __forceinline__ void chunk(uint32_t (&acc)[64], int c, const Tile& t,
                                        State& st) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 w = st.w[j];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        st.f[i] += static_cast<float>(static_cast<int>(acc[i])) *
                   (st.hr[e >> 1] * ((e & 1) ? w.y : w.x));
      }
    }
    if (c + 1 < n_chunks) load_hr(t, st, c + 1);  // in flight during the next chunk
  }

  __device__ __forceinline__ void finish(const Tile& t, State& st) const {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.col(j);
      if (col >= t.N) continue;
      const float2 b = load_bf16x2(b2 + col);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = t.row(r);
        if (row >= t.M) continue;
        const size_t at = static_cast<size_t>(row) * t.N + col;
        const float2 res = load_bf16x2(x + at);
        store_bf16x2(out + at, st.f[4 * j + 2 * r] + b.x + res.x,
                     st.f[4 * j + 2 * r + 1] + b.y + res.y);
      }
    }
  }
};

}  // namespace i8_sm90
}  // namespace ullava

// x, out [rows, C] bf16; ln_s, ln_b, b2 [C] bf16; w1q int8 [F][C] (C
// contiguous), s1 [F] f32, b1 [F] bf16; w2q int8 [C][F] (F contiguous),
// s2 [C] f32. Scratch: xq [rows, C] int8, xs [rows] f32, hq [rows, F]
// int8, hs [rows, F / f_chunk] f32. f_chunk is a multiple of 256 (whole
// k-blocks of fc2), at most 1024 (a cluster of 8 column tiles of fc1), and
// divides F. `stages`: bit 0 the row pass, bit 1 fc1, bit 2 fc2
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
    i8_sm90::Fc1Epi epi{static_cast<const float*>(xs), static_cast<const float*>(s1),
                        static_cast<const bf16*>(b1), static_cast<int8_t*>(hq),
                        static_cast<float*>(hs), n_chunks, f_chunk / i8_sm90::BN};
    const int KT = (C + i8_sm90::BK - 1) / i8_sm90::BK;
    const int err = i8_sm90::launch_gemm(static_cast<const int8_t*>(xq), C, rows,
                                         static_cast<const int8_t*>(w1q), C, F, C, KT, epi,
                                         f_chunk / i8_sm90::BN, st);
    if (err != 0) return err;
  }
  if (stages & 4) {
    i8_sm90::Fc2Epi epi{static_cast<const float*>(hs), static_cast<const float*>(s2),
                        static_cast<const bf16*>(b2), static_cast<const bf16*>(x),
                        static_cast<bf16*>(out), n_chunks};
    return i8_sm90::launch_gemm(static_cast<const int8_t*>(hq), F, rows,
                                static_cast<const int8_t*>(w2q), F, C, F, f_chunk / i8_sm90::BK,
                                epi, 1, st);
  }
  return 0;
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the fc1 (`fc`
// 1) or fc2 (2) kernel.
ULLAVA_EXPORT int ullava_fused_mlp_block_int8_attrs(int fc, int* out) {
  using namespace ullava::i8_sm90;
  return fc == 1 ? attrs<Fc1Epi>(out) : attrs<Fc2Epi>(out);
}
