// rms_norm_residual_quant / rms_norm_quant and the RMSNorm forward:
// one templated row kernel.
//
// Replaces: ullava_tpu/ops/norms.py:139 _rms_quant_call (kernel
// _rms_quant_kernel, :116) and ullava_tpu/ops/norms.py:77 _rms_norm_pallas
// forward (kernel _rms_fwd_kernel, :21). The TPU kernels take blocks of up
// to 512 rows through VMEM on a sequential grid.
//
// Bound on the card: bytes. The fused form reads x and res (2 B each per
// element) and writes h (2 B) and the int8 row (1 B): 7 B per element for
// about 10 flops; the plain norm reads 2 B and writes 2 B.
//
// Design: one block of 256 threads per row, every global access a 16-byte
// vector of 8 bf16 (or 8 int8 as 8 bytes). Pass 1 forms the fp32 sum
// x + res, stores its bf16 rounding as the residual stream h, and keeps
// the UNROUNDED fp32 row in shared memory, so that the norm and the
// quantization start from the fp32 sum as the TPU kernel's do. A block
// reduction gives the mean square, pass 2 norms the staged row and takes
// the abs-max, a second reduction, and pass 3 rounds half to even
// (cvt.rni, as jnp.round) into int8. Device memory is touched once per
// element in each direction.
//
// The RMSNorm forward has a second form for a decode step's few rows (16
// at the int8 serve's B=16), where the time is latency, not bytes (16 x
// 4096 bf16 in and out is 0.08 us at HBM rate): the staged kernel above
// runs a serial chain (load x, stage it, reduce, only then load w, a second
// dependent memory round trip, normalize, store) with two barriers.
// `rms_fwd_rows_kernel` keeps one block of 256 threads a row, but every
// thread loads its 16-byte vectors of x AND w at entry into registers (no
// shared-memory staging), the sum of squares goes through warp shuffles and
// one barrier, and the row is normalized from registers: one memory round
// trip. (A row spread over a thread block cluster of 8 CTAs, partials
// exchanged through distributed shared memory, was tried first: its
// cluster launch and barriers cost more than the 128 CTAs' parallelism
// gained, and it ran slower than the staged kernel; PERF.md.) The wrapper
// (ops/norms.py) takes this form up to a row count measured on the card,
// the staged one above it.
//
// Deliberate bug for the correctness gate (chip_smoke.py), built only into
// a copy of this source: ULLAVA_MUTANT_RMS_ROWS_PARTIAL leaves the last
// warp's partial out of the row's sum of squares.
#include "row_quant.cuh"

namespace ullava {

template <bool kResidual, bool kQuant>
__global__ void __launch_bounds__(kRowThreads)
rms_row_kernel(const bf16* __restrict__ x, const bf16* __restrict__ res,
               const bf16* __restrict__ w, bf16* __restrict__ h_out,
               bf16* __restrict__ y_out, int8_t* __restrict__ q_out,
               float* __restrict__ amax_out, int D, float eps) {
  extern __shared__ float smem[];
  float* row = smem;
  float* scratch = smem + D;
  const long long base = static_cast<long long>(blockIdx.x) * D;
  const int vecs = D / 8;

  float ss = 0.f;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    float f[8];
    load_bf16x8(x + base + v * 8, f);
    if (kResidual) {
      float r[8];
      load_bf16x8(res + base + v * 8, r);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] += r[i];
      store_bf16x8(h_out + base + v * 8, f);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      row[v * 8 + i] = f[i];
      ss += f[i] * f[i];
    }
  }
  const float mean = block_reduce<false>(ss, scratch) / static_cast<float>(D);
  const float r = rsqrtf(mean + eps);

  float am = 0.f;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
    float wf[8], n[8];
    load_bf16x8(w + v * 8, wf);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      n[i] = row[v * 8 + i] * r * wf[i];
      am = fmaxf(am, fabsf(n[i]));
    }
    if (kQuant) {
#pragma unroll
      for (int i = 0; i < 8; ++i) row[v * 8 + i] = n[i];
    } else {
      store_bf16x8(y_out + base + v * 8, n);
    }
  }
  if (!kQuant) return;

  const float amax = fmaxf(block_reduce<true>(am, scratch), 1e-12f);
  const float s = 127.0f / amax;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x)
    store_int8x8(q_out + base + v * 8, row + v * 8, s);
  if (threadIdx.x == 0) amax_out[blockIdx.x] = amax;
}

constexpr int kRowsThreads = 256;
// Vectors a thread holds: enough for the widest row the wrapper takes
// (12256 = (48 KB - 128) / 4, the staged kernel's limit).
constexpr int kRowsPasses = 6;
constexpr int kRowsMaxWidth = kRowsThreads * 8 * kRowsPasses;

// y = x * rsqrt(mean(x^2) + eps) * w for row blockIdx.x; the thread holds
// vectors p * 256 + thread of x and w in registers.
__global__ void __launch_bounds__(kRowsThreads)
rms_fwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, int D, float eps) {
  constexpr int kWarps = kRowsThreads / 32;
  __shared__ float part[kWarps];
  const long long base = static_cast<long long>(blockIdx.x) * D;
  const int vecs = D / 8;
  uint4 xv[kRowsPasses], wv[kRowsPasses];
#pragma unroll
  for (int p = 0; p < kRowsPasses; ++p) {
    const int v = p * kRowsThreads + threadIdx.x;
    if (v < vecs) {
      xv[p] = *reinterpret_cast<const uint4*>(x + base + v * 8);
      wv[p] = *reinterpret_cast<const uint4*>(w + v * 8);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int p = 0; p < kRowsPasses; ++p) {
    if (p * kRowsThreads + static_cast<int>(threadIdx.x) < vecs) {
      float f[8];
      unpack_bf16x8(xv[p], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += f[i] * f[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  // Every thread sums the warps' partials in the same order.
  float tot = 0.f;
#ifdef ULLAVA_MUTANT_RMS_ROWS_PARTIAL
#pragma unroll
  for (int i = 0; i < kWarps - 1; ++i) tot += part[i];
#else
#pragma unroll
  for (int i = 0; i < kWarps; ++i) tot += part[i];
#endif
  const float r = rsqrtf(tot / static_cast<float>(D) + eps);
#pragma unroll
  for (int p = 0; p < kRowsPasses; ++p) {
    const int v = p * kRowsThreads + threadIdx.x;
    if (v < vecs) {
      float f[8], wf[8];
      unpack_bf16x8(xv[p], f);
      unpack_bf16x8(wv[p], wf);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = f[i] * r * wf[i];
      store_bf16x8(y + base + v * 8, f);
    }
  }
}

template <bool kResidual, bool kQuant>
int launch_rms_row(const void* x, const void* res, const void* w, void* h_out,
                   void* y_out, void* q_out, void* amax_out, int rows, int D,
                   float eps, void* stream) {
  if (rows > 0)
    rms_row_kernel<kResidual, kQuant>
        <<<rows, kRowThreads, row_smem_bytes(D), static_cast<cudaStream_t>(stream)>>>(
            static_cast<const bf16*>(x), static_cast<const bf16*>(res),
            static_cast<const bf16*>(w), static_cast<bf16*>(h_out),
            static_cast<bf16*>(y_out), static_cast<int8_t*>(q_out),
            static_cast<float*>(amax_out), D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ullava

// x, res, h_out: [rows, D] bf16; w: [D] bf16; q_out: [rows, D] int8;
// amax_out: [rows] f32. res and h_out are both null for the no-residual
// form. D % 8 == 0 and (D + 32) * 4 <= 48 KB (checked by the wrapper).
ULLAVA_EXPORT int ullava_rms_norm_residual_quant(const void* x, const void* res,
                                                 const void* w, void* h_out,
                                                 void* q_out, void* amax_out,
                                                 int rows, int D, float eps,
                                                 void* stream) {
  if (res != nullptr)
    return ullava::launch_rms_row<true, true>(x, res, w, h_out, nullptr, q_out,
                                              amax_out, rows, D, eps, stream);
  return ullava::launch_rms_row<false, true>(x, nullptr, w, nullptr, nullptr,
                                             q_out, amax_out, rows, D, eps, stream);
}

// x, out: [rows, D] bf16; w: [D] bf16. `few_rows` 1 takes the few-row
// form (x and w in registers; D % 8 == 0 and D <= 12288), 0 the staged one.
ULLAVA_EXPORT int ullava_rms_norm_fwd(const void* x, const void* w, void* out,
                                      int rows, int D, float eps, int few_rows, void* stream) {
  using namespace ullava;
  if (!few_rows)
    return launch_rms_row<false, false>(x, nullptr, w, nullptr, out, nullptr, nullptr, rows, D,
                                        eps, stream);
  if (D > kRowsMaxWidth) return static_cast<int>(cudaErrorInvalidValue);
  if (rows > 0)
    rms_fwd_rows_kernel<<<rows, kRowsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), D,
        eps);
  return static_cast<int>(cudaGetLastError());
}
