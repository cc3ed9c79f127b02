// fused_ln_linear / fused_linear (w8a8): optional LayerNorm, per-row int8
// quantization of the fp32 result, int8 x int8 -> int32 product with an
// int8 weight, y = acc * (xs * w_scale) + bias (+ residual), one rounding
// to bf16.
//
// Replaces: ullava_tpu/ops/mlp_kernel.py:491 fused_ln_linear and :704
// fused_linear (one Pallas kernel that keeps a 1024-row tile, its LN'd
// int8 copy and the whole [C, F] weight in VMEM).
//
// Bound on the card: LN+qkv of a ViT-H global block at B=16 is 65536 x
// 1280 x 3840 x 2 = 6.4e11 int8 operations (0.33 ms at 1,979 TOP/s)
// against 0.68 GB of input and output (0.20 ms): operations bound it. The
// proj form (N = 1280, plus a residual read) is bound by its 0.50 GB.
//
// Design: two launches, because a 1024-row tile with its accumulator does
// not fit an SM's shared memory. (1) A row pass (one warp per row,
// ln_quant_rows.cuh, shared with K12, K13 and K23) does the LayerNorm in fp32
// and writes int8 rows and one fp32 scale per row to scratch: 1 byte per
// element leaves and re-enters HBM, a sixth of the kernel's own traffic.
// (2) One launch of the wgmma + TMA int8 core (int8_gemm_sm90.cuh), one
// block a 128 x 128 tile, with LinearEpi: before the tile's products each
// consumer thread loads its two rows' scales, its 16 column pairs' weight
// scales and biases and, in the proj form, its 2 x 16 residual pairs, so
// that those reads run in the products' shadow; after them it forms
// acc * (xs * w_scale) + bias (+ residual) in fp32 and stores bf16. (On
// the mma.sync core, which this replaces, the residual and the scales were
// read after the products.)
//
// fused_ln_linear_dual (w8a8): the same with a second int8 weight on the
// same int8 rows, P = acc2 * (xs * w2_scale) + bias2 (an f32 bias), of
// which only the leading `rows2` rows of every T are kept.
//
// Replaces: ullava_tpu/ops/mlp_kernel.py:622 fused_ln_linear_dual (one
// Pallas kernel: both products of a block of windows in its body).
//
// Bound on the card: LN1 + qkv + the 864 composite bias columns of the
// full windows of a ViT-H layer at B=16 is 51200 x 1280 x 4704 x 2 =
// 6.2e11 int8 operations (0.31 ms) against 0.62 GB (0.18 ms): operations
// bound it.
//
// Design: the row pass, then ONE launch of the same core over both
// weights: column tiles [0, ceil(F/128))
// read W and store y = acc * (xs * w_scale) + bf16 bias, all rows; the
// ceil(F2/128) after them read W2 (its tensor map zero-fills rows past F2,
// the epilogue masks those columns) and store P = acc * (xs * w2_scale) +
// f32 bias2 for the leading rows2 rows of every T only, GEMM row r at
// output row (r / T) * rows2 + r % T. So the int8 rows are read once, not
// twice, and a class costs two launches, not three (the corner's second
// product was pure launch latency). The epilogue's scales and biases
// load before the tile's products, not after.
// K = 1280 is only five 256-byte k-blocks, so a persistent tile loop (one
// block an SM, the producer loading the next tile while the consumers
// store this one) was tried: on an H100 it ran 12-16% slower than one
// block a tile in every class (a tile's time goes to its products and its
// store, which it does not overlap), and was taken out again.
//
// Deliberate bugs for the correctness gate (chip_smoke.py), each built
// only into a copy of this source under its define:
//   ULLAVA_MUTANT_DUAL_TILE_OFFSET     the bias-term tiles read W2 one tile
//                                      over (int8_gemm_sm90.cuh);
//   ULLAVA_MUTANT_DUAL_W_SCALE         the bias-term columns scaled by W's
//                                      scale, not W2's;
//   ULLAVA_MUTANT_LINEAR_RESIDUAL_ROW  fused_linear's prefetched residual
//                                      taken from the thread's other row.
#include "ln_quant_rows.cuh"
#include "int8_gemm_sm90.cuh"

namespace ullava {
namespace i8_sm90 {

// fused_ln_linear's product: y = acc * (xs * w) + bias (+ residual), one
// rounding to bf16.
struct LinearEpi {
  // The thread's operands, loaded before the tile's products: its two
  // rows' scales, its 16 column pairs' weight scales and biases and, with
  // a residual, its two rows' 16 residual pairs (bf16 pairs as loaded).
  struct State {
    float xr[2];
    float2 w[16];
    uint32_t b[16];
    uint32_t res[2][16];
  };
  static constexpr int kClusterSyncs = 0;
  static constexpr int kScratchBytes = 0;
  const float* xs;       // [M] per-row activation scale
  const float* ws;       // [N] per-column weight scale
  const bf16* bias;      // [N]
  const bf16* residual;  // [M, N] or nullptr
  bf16* out;             // [M, N]

  __device__ __forceinline__ void begin(const Tile& t, State& st) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) st.xr[r] = t.row(r) < t.M ? xs[t.row(r)] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.col(j);
      st.w[j] = make_float2(0.f, 0.f);
      st.b[j] = 0u;
      if (col >= t.N) continue;
      st.w[j] = *reinterpret_cast<const float2*>(ws + col);
      st.b[j] = *reinterpret_cast<const uint32_t*>(bias + col);
    }
    if (residual == nullptr) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#ifdef ULLAVA_MUTANT_LINEAR_RESIDUAL_ROW
      const int row = t.row(1 - r);  // the thread's other row
#else
      const int row = t.row(r);
#endif
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = t.col(j);
        st.res[r][j] = row < t.M && col < t.N
                           ? *reinterpret_cast<const uint32_t*>(
                                 residual + static_cast<size_t>(row) * t.N + col)
                           : 0u;
      }
    }
  }

  __device__ __forceinline__ void chunk(uint32_t (&acc)[64], int, const Tile& t,
                                        State& st) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t.row(r);
      if (row >= t.M) continue;
      bf16* orow = out + static_cast<size_t>(row) * t.N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = t.col(j);
        if (col >= t.N) continue;
        const float2 b = bf16x2_to_float2(st.b[j]);
        float y0 = static_cast<float>(static_cast<int>(acc[4 * j + 2 * r])) *
                       (st.xr[r] * st.w[j].x) + b.x;
        float y1 = static_cast<float>(static_cast<int>(acc[4 * j + 2 * r + 1])) *
                       (st.xr[r] * st.w[j].y) + b.y;
        if (residual != nullptr) {
          const float2 res = bf16x2_to_float2(st.res[r][j]);
          y0 += res.x;
          y1 += res.y;
        }
        store_bf16x2(orow + col, y0, y1);
      }
    }
  }
  __device__ __forceinline__ void finish(const Tile&, State&) const {}
};

// Both products of fused_ln_linear_dual on the wgmma core, by the tile's
// part: 0 the qkv columns (bf16 bias, every row), 1 the bias-term columns
// (f32 bias, of every T rows the leading rows2, packed to [M / T, rows2,
// N2]). The arithmetic is LinearEpi's: acc * (xs * w) + b, one rounding.
struct DualLinearEpi {
  // The thread's operands, loaded before the tile's products: its two
  // rows' scales and its 16 column pairs' weight scales and biases.
  struct State {
    float xr[2];
    float2 w[16], b[16];
  };
  static constexpr int kClusterSyncs = 0;
  static constexpr int kScratchBytes = 0;
  const float* xs;     // [M] per-row activation scale
  const float* ws;     // [N] W's per-column scale
  const bf16* bias;    // [N]
  bf16* out;           // [M, N]
  const float* ws2;    // [N2] W2's per-column scale
  const float* bias2;  // [N2]
  bf16* out2;          // [M / T, rows2, N2]
  int T, rows2;

  // Whether GEMM row `row` is stored, and where its output row starts.
  __device__ __forceinline__ bf16* out_row(const Tile& t, int row) const {
    if (row >= t.M) return nullptr;
    if (t.part == 0) return out + static_cast<size_t>(row) * t.N;
    if (row % T >= rows2) return nullptr;
    return out2 + (static_cast<size_t>(row / T) * rows2 + row % T) * t.N;
  }

  __device__ __forceinline__ void begin(const Tile& t, State& st) const {
#ifdef ULLAVA_MUTANT_DUAL_W_SCALE
    const float* wsp = ws;
#else
    const float* wsp = t.part == 0 ? ws : ws2;
#endif
#pragma unroll
    for (int r = 0; r < 2; ++r) st.xr[r] = t.row(r) < t.M ? xs[t.row(r)] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.col(j);
      st.w[j] = st.b[j] = make_float2(0.f, 0.f);
      if (col >= t.N) continue;
      st.w[j] = *reinterpret_cast<const float2*>(wsp + col);
      st.b[j] = t.part == 0 ? load_bf16x2(bias + col)
                            : *reinterpret_cast<const float2*>(bias2 + col);
    }
  }

  __device__ __forceinline__ void chunk(uint32_t (&acc)[64], int, const Tile& t,
                                        State& st) const {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* orow = out_row(t, t.row(r));
      if (orow == nullptr) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = t.col(j);
        if (col >= t.N) continue;
        store_bf16x2(orow + col,
                     static_cast<float>(static_cast<int>(acc[4 * j + 2 * r])) *
                             (st.xr[r] * st.w[j].x) + st.b[j].x,
                     static_cast<float>(static_cast<int>(acc[4 * j + 2 * r + 1])) *
                             (st.xr[r] * st.w[j].y) + st.b[j].y);
      }
    }
  }
  __device__ __forceinline__ void finish(const Tile&, State&) const {}
};

}  // namespace i8_sm90
}  // namespace ullava

// x [rows, K] bf16; ln_s, ln_b [K] bf16 or both null (no LayerNorm);
// wq int8, K contiguous per output column ([N][K]); w_scale [N] f32;
// bias [N] bf16; residual [rows, N] bf16 or null; out [rows, N] bf16;
// scratch xq [rows, K] int8 and xs [rows] f32. `stages`: bit 0 runs the
// row pass, bit 1 the GEMM (3 = the function; the single bits exist so
// that each stage can be timed alone).
ULLAVA_EXPORT int ullava_fused_ln_linear_int8(const void* x, const void* ln_s, const void* ln_b,
                                              const void* wq, const void* w_scale,
                                              const void* bias, const void* residual, void* out,
                                              void* xq, void* xs, int rows, int K, int N,
                                              float eps, int stages, void* stream) {
  using namespace ullava;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages & 1) {
    const int err = i8::launch_ln_quant_rows(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s),
        static_cast<const bf16*>(ln_b), static_cast<int8_t*>(xq), static_cast<float*>(xs), rows,
        K, eps, st);
    if (err != 0) return err;
  }
  if (stages & 2) {
    const i8_sm90::LinearEpi epi{static_cast<const float*>(xs),
                                 static_cast<const float*>(w_scale),
                                 static_cast<const bf16*>(bias),
                                 static_cast<const bf16*>(residual), static_cast<bf16*>(out)};
    const int KT = (K + i8_sm90::BK - 1) / i8_sm90::BK;
    return i8_sm90::launch_gemm(static_cast<const int8_t*>(xq), K, rows,
                                static_cast<const int8_t*>(wq), K, N, K, KT, epi, 1, st);
  }
  return 0;
}

// fused_ln_linear_dual. x [rows, K] bf16 with rows = windows * T;
// ln_s, ln_b [K] bf16; wq [N][K] and w2q [N2][K] int8; w_scale [N],
// w2_scale [N2] f32; bias [N] bf16; bias2 [N2] f32; out [rows, N] bf16;
// out2 [rows / T, rows2, N2] bf16; scratch xq [rows, K] int8 and xs [rows]
// f32. `stages`: bit 0 runs the row pass, bit 1 the qkv columns, bit 2 the
// bias-term columns (7 = the function: both column ranges in one launch).
ULLAVA_EXPORT int ullava_fused_ln_linear_dual_int8(
    const void* x, const void* ln_s, const void* ln_b, const void* wq, const void* w_scale,
    const void* bias, const void* w2q, const void* w2_scale, const void* bias2, void* out,
    void* out2, void* xq, void* xs, int rows, int K, int N, int N2, int T, int rows2, float eps,
    int stages, void* stream) {
  using namespace ullava;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages & 1) {
    const int err = i8::launch_ln_quant_rows(
        static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s),
        static_cast<const bf16*>(ln_b), static_cast<int8_t*>(xq), static_cast<float*>(xs), rows,
        K, eps, st);
    if (err != 0) return err;
  }
  if (stages & 6) {
    const i8_sm90::DualLinearEpi epi{
        static_cast<const float*>(xs), static_cast<const float*>(w_scale),
        static_cast<const bf16*>(bias), static_cast<bf16*>(out),
        static_cast<const float*>(w2_scale), static_cast<const float*>(bias2),
        static_cast<bf16*>(out2), T, rows2};
    const int KT = (K + i8_sm90::BK - 1) / i8_sm90::BK;
    const int n = (stages & 2) ? N : 0, n2 = (stages & 4) ? N2 : 0;
    const auto* a = static_cast<const int8_t*>(xq);
    const auto* w = static_cast<const int8_t*>(wq);
    const auto* w2 = static_cast<const int8_t*>(w2q);
    return i8_sm90::launch_gemm2(a, K, rows, w, K, n, w2, K, n2, K, KT, epi, 1, st);
  }
  return 0;
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the dual
// GEMM's kernel.
ULLAVA_EXPORT int ullava_fused_ln_linear_dual_int8_attrs(int* out) {
  using namespace ullava::i8_sm90;
  return attrs<DualLinearEpi>(out);
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the single
// GEMM's kernel (fused_ln_linear's).
ULLAVA_EXPORT int ullava_fused_ln_linear_int8_attrs(int* out) {
  using namespace ullava::i8_sm90;
  return attrs<LinearEpi>(out);
}
