// The fused MLP's GELU, shared by both forms of fused_mlp_block
// (mlp_block_int8.cu, mlp_block_wq.cu): 0.5 x (1 + erf(x / sqrt(2))) with
// erf(t) ~ t * P(t^2) on |t| <= 3, saturated to +-1 beyond: the TPU
// kernel's coefficients and clamp (ullava_tpu/ops/mlp_kernel.py:31-64).
#pragma once

namespace ullava {
namespace i8 {

__device__ __forceinline__ float erf_poly(float x) {
  const float a = fabsf(x);
  const float t = fminf(a, 3.0f);
  const float u = t * t;
  float p = -4.971512367804531e-07f;
  p = p * u + 2.0252568341883032e-05f;
  p = p * u + -0.0003563589626086337f;
  p = p * u + 0.0036059320467746367f;
  p = p * u + -0.023743737062092228f;
  p = p * u + 0.10971839155099318f;
  p = p * u + -0.37489969643977966f;
  p = p * u + 1.128298328383344f;
  const float e = a > 3.0f ? 1.0f : t * p;
  return copysignf(e, x);
}

__device__ __forceinline__ float gelu_poly(float x) {
  return 0.5f * x * (1.0f + erf_poly(x * 0.7071067811865476f));
}

}  // namespace i8
}  // namespace ullava
