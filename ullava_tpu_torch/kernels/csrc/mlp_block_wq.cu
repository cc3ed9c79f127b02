// fused_mlp_block, weight-only (w8a8=False, 2-D form):
// x + fc2(gelu(fc1(LN(x)))) with both products bf16 x int8-weight (the
// weight widened to bf16, exact) and fp32 accumulation, the GELU by the
// polynomial erf, and h rounded to bf16 before fc2.
//
// Replaces: ullava_tpu/ops/mlp_kernel.py:157 fused_mlp_block with
// w8a8=False (_kernel, :77, branches :122-127 and :143-148: per F-chunk
// h = gelu(dot(xn, w1) * s1 + b1), acc += dot(bf16(h), w2) * s2; then
// acc + b2 + x, one rounding).
//
// Bound on the card: a ViT-H global block's MLP at B=4 is 2 x 16384 x
// 1280 x 5120 x 2 = 4.3e11 bf16 flops, 0.43 ms at 989 TFLOP/s, against
// 0.10 GB of input and output (0.03 ms): operations bound it.
//
// Design: three launches. An SM cannot hold a row tile's [rows, 1280]
// fp32 accumulator next to the operand tiles, so h crosses HBM once, as
// the bf16 values that fc2 takes anyway (the TPU kernel's h.astype(bf16)).
//   1. row pass: LayerNorm in fp32, rounded to bf16 (bf16_wq_gemm_core.cuh);
//   2. fc1 on the bf16 x int8 core; the epilogue computes
//      h = gelu(acc * s1 + b1) in registers and stores it as bf16;
//   3. fc2 on the same core over all of F at once, epilogue
//      acc * s2 + b2 + x. The TPU kernel multiplies each F-chunk's
//      product by s2 before summing the chunks; s2 is one value per output
//      column, so the sum over chunks times s2 is the same up to fp32
//      rounding, and the kernel takes it once.
#include "bf16_wq_gemm_core.cuh"
#include "gelu_poly.cuh"

namespace ullava {
namespace wq {

struct Fc1Epi {
  static constexpr int kMinBlocks = 2;
  const float* s1;  // [F]
  const bf16* b1;   // [F]
  bf16* h;          // [M, F]

  __device__ __forceinline__ void finish(const Acc& acc, const Tile& t) const {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int col = t.col(ni);
      if (col >= t.N) continue;
      const float2 w = *reinterpret_cast<const float2*>(s1 + col);
      const float2 b = load_bf16x2(b1 + col);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = t.row(mi, half);
          if (row >= t.M) continue;
          store_bf16x2(h + static_cast<size_t>(row) * t.N + col,
                       i8::gelu_poly(acc[mi][ni][half * 2] * w.x + b.x),
                       i8::gelu_poly(acc[mi][ni][half * 2 + 1] * w.y + b.y));
        }
    }
  }
};

}  // namespace wq
}  // namespace ullava

// x, out [rows, C] bf16; ln_s, ln_b, b2 [C] bf16; w1q int8 [F][C] (C
// contiguous), s1 [F] f32, b1 [F] bf16; w2q int8 [C][F] (F contiguous),
// s2 [C] f32. Scratch: xn [rows, C] bf16, h [rows, F] bf16. `stages`: bit
// 0 the row pass, bit 1 fc1, bit 2 fc2 (7 = the function).
ULLAVA_EXPORT int ullava_fused_mlp_block_wq(const void* x, const void* ln_s, const void* ln_b,
                                            const void* w1q, const void* s1, const void* b1,
                                            const void* w2q, const void* s2, const void* b2,
                                            void* out, void* xn, void* h, int rows, int C, int F,
                                            float eps, int stages, void* stream) {
  using namespace ullava;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages & 1) {
    const int err = wq::launch_ln_rows_bf16(static_cast<const bf16*>(x),
                                            static_cast<const bf16*>(ln_s),
                                            static_cast<const bf16*>(ln_b),
                                            static_cast<bf16*>(xn), rows, C, eps, st);
    if (err != 0) return err;
  }
  if (stages & 2) {
    wq::Fc1Epi epi{static_cast<const float*>(s1), static_cast<const bf16*>(b1),
                   static_cast<bf16*>(h)};
    const int err = wq::launch_gemm(static_cast<const bf16*>(xn), C, rows,
                                    static_cast<const int8_t*>(w1q), C, F, C, epi, st);
    if (err != 0) return err;
  }
  if (stages & 4) {
    wq::LinearEpi<bf16> epi{static_cast<const float*>(s2), static_cast<const bf16*>(b2),
                            static_cast<const bf16*>(x), static_cast<bf16*>(out), rows, rows};
    return wq::launch_gemm(static_cast<const bf16*>(h), F, rows,
                           static_cast<const int8_t*>(w2q), F, C, F, epi, st);
  }
  return 0;
}
