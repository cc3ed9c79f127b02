// fused_mlp_block, weight-only (w8a8=False, 2-D form):
// x + fc2(gelu(fc1(LN(x)))) with both products bf16 x int8-weight (the
// weight widened to bf16, exact) and fp32 accumulation, the GELU by the
// polynomial erf, and h rounded to bf16 before fc2.
//
// Replaces: ullava_tpu/ops/mlp_kernel.py:157 fused_mlp_block with
// w8a8=False (_kernel, :77, branches :122-128 and :143-148: per F-chunk
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
//   1. row pass: LayerNorm in fp32, rounded to bf16 (ln_rows_bf16.cuh);
//   2. fc1 on the wgmma + TMA bf16 x int8-weight core
//      (bf16_wq_gemm_sm90.cuh: W1t [F, C] widened in registers as wgmma's
//      A, the LN'd rows from shared memory as its B); the epilogue computes
//      h = gelu(acc * s1 + b1) per channel and stores it as bf16, token-major;
//   3. fc2 on the same core with A = W2t [C, F] and B = h [rows, F], K = F,
//      over all of F at once, epilogue acc * s2 + b2 + x (x read by TMA
//      under the products). The TPU kernel multiplies each F-chunk's
//      product by s2 before summing the chunks; s2 is one value per output
//      channel, so the sum over chunks times s2 is the same up to fp32
//      rounding, and the kernel takes it once.
// The deliberate bugs of the core (ULLAVA_MUTANT_WQ_*, in its header)
// compile into copies of this source that only chip_smoke.py builds.
#include "ln_rows_bf16.cuh"
#include "bf16_wq_gemm_sm90.cuh"

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
    const int err = wq_sm90::launch_gemm<wq_sm90::GeluForm>(
        static_cast<const bf16*>(xn), C, rows, static_cast<const int8_t*>(w1q), C, F, C,
        static_cast<const float*>(s1), static_cast<const bf16*>(b1), nullptr,
        static_cast<bf16*>(h), st);
    if (err != 0) return err;
  }
  if (stages & 4)
    return wq_sm90::launch_gemm<wq_sm90::LinearForm>(
        static_cast<const bf16*>(h), F, rows, static_cast<const int8_t*>(w2q), F, C, F,
        static_cast<const float*>(s2), static_cast<const bf16*>(b2),
        static_cast<const bf16*>(x), static_cast<bf16*>(out), st);
  return 0;
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the fc1 (`fc`
// 1) or fc2 (2) kernel.
ULLAVA_EXPORT int ullava_fused_mlp_block_wq_attrs(int fc, int* out) {
  using namespace ullava::wq_sm90;
  return fc == 1 ? attrs<GeluForm>(out) : attrs<LinearForm>(out);
}
