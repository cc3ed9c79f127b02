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
// not fit an SM's shared memory. (1) A row pass (one warp per row) does
// the LayerNorm in fp32 and writes int8 rows and one fp32 scale per row
// to scratch: 1 byte per element leaves and re-enters HBM, a sixth of the
// kernel's own traffic. (2) The shared int8 GEMM core (int8_gemm_core.cuh)
// with an epilogue that multiplies the two scales first, as the TPU
// kernel does, adds the bias and the residual in fp32 and stores bf16.
#include "int8_gemm_core.cuh"

namespace ullava {
namespace i8 {

struct LinearEpi {
  using State = NoState;
  static constexpr int kMinBlocks = 2;
  const float* xs;      // [M] per-row activation scale
  const float* ws;      // [N] per-output-channel weight scale
  const bf16* bias;     // [N]
  const bf16* residual; // [M, N] or nullptr
  bf16* out;            // [M, N]

  __device__ __forceinline__ void chunk(Acc& acc, int, const Tile& t, State&) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = t.col(ni);
      if (col >= t.N) continue;
      const float2 w = *reinterpret_cast<const float2*>(ws + col);
      const float2 b = load_bf16x2(bias + col);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = t.row(mi, half);
          if (row >= t.M) continue;
          const float s = xs[row];
          float y0 = static_cast<float>(acc[mi][ni][half * 2]) * (s * w.x) + b.x;
          float y1 = static_cast<float>(acc[mi][ni][half * 2 + 1]) * (s * w.y) + b.y;
          const size_t at = static_cast<size_t>(row) * t.N + col;
          if (residual != nullptr) {
            const float2 r = load_bf16x2(residual + at);
            y0 += r.x;
            y1 += r.y;
          }
          store_bf16x2(out + at, y0, y1);
        }
      }
    }
  }
  __device__ __forceinline__ void finish(const Tile&, State&) const {}
};

}  // namespace i8
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
    i8::LinearEpi epi{static_cast<const float*>(xs), static_cast<const float*>(w_scale),
                      static_cast<const bf16*>(bias), static_cast<const bf16*>(residual),
                      static_cast<bf16*>(out)};
    const int KT = (K + i8::BK - 1) / i8::BK;
    return i8::launch_gemm(static_cast<const int8_t*>(xq), K, rows,
                           static_cast<const int8_t*>(wq), K, N, K, KT, epi, 1, st);
  }
  return 0;
}
