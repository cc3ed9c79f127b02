// fused_ln_linear / fused_linear, weight-only (w8a8=False): optional
// LayerNorm in fp32, the normalised row rounded to bf16, a bf16 product
// with the int8 weight widened to bf16 (exact) and fp32 accumulation,
// y = acc * w_scale + bias (+ residual), one rounding to bf16.
//
// Replaces: ullava_tpu/ops/mlp_kernel.py:491 fused_ln_linear and :704
// fused_linear with w8a8=False (_ln_linear_kernel, :436, whose weight-only
// branch at :465-471 converts the [C, F] int8 weight block to bf16 in
// VMEM and runs one bf16 dot).
//
// Bound on the card: LN1+qkv of a ViT-H global block at B=4 is 16384 x
// 1280 x 3840 x 2 = 1.6e11 bf16 flops (0.16 ms at 989 TFLOP/s) against
// 0.17 GB of input and output (0.05 ms): operations bound it.
//
// Design: two launches. (1) With a LayerNorm, a row pass (one warp per
// row, ln_rows_bf16.cuh) writes the normalised rows as bf16 to scratch;
// without one the product reads x itself. (2) One launch of the wgmma +
// TMA bf16 x int8-weight core (bf16_wq_gemm_sm90.cuh): the weight rows
// widened to bf16 in registers as wgmma's A operand, the rows of x from
// shared memory as its B, the output tile transposed; its epilogue
// applies the per-channel scale after the product, as the TPU kernel
// does, then the bias and the residual (read by TMA under the products),
// and stores the tile token-major by TMA.
//
// fused_ln_linear_dual, weight-only: the same row pass once, then one
// launch of the same core over both weights (its DualForm): W's channel
// tiles, then W2's, all reading the shared bf16 rows; W2's epilogue takes
// the f32 bias and keeps the leading `rows2` rows of every T (GEMM row r
// -> output row (r / T) * rows2 + r % T), each token row copied out of
// the shared output tile to its window's place by 16-byte stores.
//
// Bound on the card: the dual LN1+qkv of a B=4 encode's full windows is
// 2 x 1280 x (12800 x 3840 + 12544 x 864) = 1.5e11 bf16 flops (0.155 ms
// at 989 TFLOP/s) against 0.16 GB of input and output: operations.
//
// Replaces: ullava_tpu/ops/mlp_kernel.py:622 fused_ln_linear_dual with
// w8a8=False (_ln_linear2_kernel, :576, branch :606-615).
//
// The deliberate bugs of the core (ULLAVA_MUTANT_WQ_*, in its header)
// compile into copies of this source that only chip_smoke.py builds.
#include "ln_rows_bf16.cuh"
#include "bf16_wq_gemm_sm90.cuh"

// x [rows, K] bf16; ln_s, ln_b [K] bf16 or both null (no LayerNorm); wq
// int8 [N][K] (K contiguous per output column); w_scale [N] f32; bias [N]
// bf16; residual [rows, N] bf16 or null; out [rows, N] bf16; scratch xn
// [rows, K] bf16 (unused without a LayerNorm). `stages`: bit 0 runs the
// row pass, bit 1 the GEMM (3 = the function).
ULLAVA_EXPORT int ullava_fused_ln_linear_wq(const void* x, const void* ln_s, const void* ln_b,
                                            const void* wq, const void* w_scale, const void* bias,
                                            const void* residual, void* out, void* xn, int rows,
                                            int K, int N, float eps, int stages, void* stream) {
  using namespace ullava;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ln = ln_s != nullptr;
  if (ln && (stages & 1)) {
    const int err = wq::launch_ln_rows_bf16(static_cast<const bf16*>(x),
                                            static_cast<const bf16*>(ln_s),
                                            static_cast<const bf16*>(ln_b),
                                            static_cast<bf16*>(xn), rows, K, eps, st);
    if (err != 0) return err;
  }
  if (stages & 2)
    return wq_sm90::launch_gemm<wq_sm90::LinearForm>(
        static_cast<const bf16*>(ln ? xn : x), K, rows, static_cast<const int8_t*>(wq), K, N, K,
        static_cast<const float*>(w_scale), static_cast<const bf16*>(bias),
        static_cast<const bf16*>(residual), static_cast<bf16*>(out), st);
  return 0;
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the product's
// kernel (the wgmma + TMA core with the linear epilogue).
ULLAVA_EXPORT int ullava_fused_ln_linear_wq_attrs(int* out) {
  return ullava::wq_sm90::attrs<ullava::wq_sm90::LinearForm>(out);
}

// fused_ln_linear_dual, weight-only. x [rows, K] bf16 with rows = windows
// * T; ln_s, ln_b [K] bf16; wq [N][K] and w2q [N2][K] int8; w_scale [N],
// w2_scale [N2] f32; bias [N] bf16; bias2 [N2] f32; out [rows, N] bf16;
// out2 [rows / T, rows2, N2] bf16; scratch xn [rows, K] bf16. `stages`:
// bit 0 runs the row pass, bit 1 W's channel tiles, bit 2 W2's (7 = the
// function: both in one launch).
ULLAVA_EXPORT int ullava_fused_ln_linear_dual_wq(
    const void* x, const void* ln_s, const void* ln_b, const void* wq, const void* w_scale,
    const void* bias, const void* w2q, const void* w2_scale, const void* bias2, void* out,
    void* out2, void* xn, int rows, int K, int N, int N2, int T, int rows2, float eps, int stages,
    void* stream) {
  using namespace ullava;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stages & 1) {
    const int err = wq::launch_ln_rows_bf16(static_cast<const bf16*>(x),
                                            static_cast<const bf16*>(ln_s),
                                            static_cast<const bf16*>(ln_b),
                                            static_cast<bf16*>(xn), rows, K, eps, st);
    if (err != 0) return err;
  }
  if (stages & 6)
    return wq_sm90::launch_dual<wq_sm90::DualForm>(
        static_cast<const bf16*>(xn), rows, K, static_cast<const int8_t*>(wq),
        (stages & 2) ? N : 0, static_cast<const float*>(w_scale), static_cast<const bf16*>(bias),
        static_cast<bf16*>(out), static_cast<const int8_t*>(w2q), (stages & 4) ? N2 : 0,
        static_cast<const float*>(w2_scale), static_cast<const float*>(bias2),
        static_cast<bf16*>(out2), T, rows2, st);
  return 0;
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the dual
// product's kernel (the core's DualForm).
ULLAVA_EXPORT int ullava_fused_ln_linear_dual_wq_attrs(int* out) {
  return ullava::wq_sm90::attrs<ullava::wq_sm90::DualForm>(out);
}
