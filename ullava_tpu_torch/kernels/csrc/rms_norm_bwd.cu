// rms_norm_bwd (K18): the RMSNorm backward, dx and (optionally) dw.
//
// Replaces: ullava_tpu/ops/norms.py:85 _rms_vjp_bwd (kernel
// _rms_bwd_kernel, :28, launched at :89), whose sequential grid adds each
// row block's dw into one [1, D] f32 block.
//
// Per row, in fp32 from the bf16 inputs: r = rsqrt(mean(x^2) + eps),
// c = sum(dy * w * x) / D, dx = (dy * w - x * r^2 * c) * r (rounded to
// bf16), and dw = sum over rows of dy * x * r (summed in fp32, rounded to
// w's bf16 once).
//
// Bound on the card: bytes. x and dy are read and dx written once, 6 B
// per element for about 10 flops; at the training shape (4096 rows of
// 4096) 101 MB, 30 us. The dw form adds its fp32 partials (below).
//
// Design: one block of 256 threads per `rpb` rows (row_quant.cuh's row
// staging, as K5, K6 and K9): pass 1 stages x and dy of a row in shared
// memory as fp32 and takes the two row sums (block reductions), pass 2
// writes dx from the staged row. Thread t owns the 8-element vectors t,
// t + 256, ... of every row, so it keeps its columns' dw sums in
// registers across the block's rows, and no barrier beyond the
// reductions' own is needed. Blocks run in no order, so with dw each
// writes its fp32 partial [D] row, and a second kernel of the same entry
// sums the partials column by column in a fixed order: deterministic, no
// atomics. Without dw, rpb is 1.
//
// ULLAVA_MUTANT_NO_C builds a deliberate bug (dx without the c term) that
// only `chip_smoke.py` compiles, to show that K18's gate catches it.
#include "row_quant.cuh"

namespace ullava {

constexpr int kRmsBwdMaxVecs = 3;  // 8-wide vectors a thread owns: D <= 3 * 8 * 256

template <bool kDw>
__global__ void __launch_bounds__(kRowThreads)
rms_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const bf16* __restrict__ dy, bf16* __restrict__ dx,
               float* __restrict__ partial, int rows, int D, int rpb, float eps) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* gs = smem + D;
  float* scratch = smem + 2 * D;
  const int vecs = D / 8;
  float acc[kRmsBwdMaxVecs][8];
#pragma unroll
  for (int i = 0; i < kRmsBwdMaxVecs; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int blk = blockIdx.x;
  const int r_end = min(rows, (blk + 1) * rpb);
  for (int row = blk * rpb; row < r_end; ++row) {
    const long long base = static_cast<long long>(row) * D;
    float ss = 0.f, cc = 0.f;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      float xf[8], gf[8], wf[8];
      load_bf16x8(x + base + v * 8, xf);
      load_bf16x8(dy + base + v * 8, gf);
      load_bf16x8(w + v * 8, wf);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xs[v * 8 + i] = xf[i];
        gs[v * 8 + i] = gf[i];
        ss += xf[i] * xf[i];
        cc += gf[i] * wf[i] * xf[i];
      }
    }
    const float r = rsqrtf(block_reduce<false>(ss, scratch) / static_cast<float>(D) + eps);
    const float c = block_reduce<false>(cc, scratch) * (1.0f / static_cast<float>(D));
#pragma unroll
    for (int i = 0; i < kRmsBwdMaxVecs; ++i) {
      const int v = threadIdx.x + i * blockDim.x;
      if (v >= vecs) break;
      float wf[8], o[8];
      load_bf16x8(w + v * 8, wf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xv = xs[v * 8 + j], gv = gs[v * 8 + j];
#ifdef ULLAVA_MUTANT_NO_C
        o[j] = gv * wf[j] * r;
#else
        o[j] = (gv * wf[j] - xv * (r * r) * c) * r;
#endif
        if (kDw) acc[i][j] += gv * xv * r;
      }
      store_bf16x8(dx + base + v * 8, o);
    }
  }
  if (!kDw) return;
#pragma unroll
  for (int i = 0; i < kRmsBwdMaxVecs; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v >= vecs) break;
    float4* out = reinterpret_cast<float4*>(partial + static_cast<size_t>(blk) * D + v * 8);
    out[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    out[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// dw[c] = sum over the nblk partial rows of column c, in block order: a
// block of 256 threads takes 32 columns, eight threads per column each sum
// every eighth partial, and one sums their eight results in order.
__global__ void __launch_bounds__(256)
rms_dw_reduce_kernel(const float* __restrict__ partial, int nblk, int D, bf16* __restrict__ dw) {
  __shared__ float part[8][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < D)
    for (int b = ty; b < nblk; b += 8) s += partial[static_cast<size_t>(b) * D + c];
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][tx];
    dw[c] = __float2bfloat16(t);
  }
}

}  // namespace ullava

// x, dy, dx: [rows, D] bf16; w: [D] bf16. With dw (bf16 [D]) non-null,
// partial is [ceil(rows / rpb), D] f32 scratch and a second kernel sums it
// into dw; without, both are null. D % 8 == 0 and (2 D + 32) * 4 <= 48 KB
// (checked by the wrapper).
ULLAVA_EXPORT int ullava_rms_norm_bwd(const void* x, const void* w, const void* dy, void* dx,
                                      void* partial, void* dw, int rows, int D, int rpb,
                                      float eps, void* stream) {
  if (rows == 0) return 0;
  const int nblk = (rows + rpb - 1) / rpb;
  const size_t smem = ullava::row_smem_bytes(2 * D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const ullava::bf16*>(x);
  const auto* wb = static_cast<const ullava::bf16*>(w);
  const auto* gb = static_cast<const ullava::bf16*>(dy);
  auto* dxb = static_cast<ullava::bf16*>(dx);
  if (dw == nullptr) {
    ullava::rms_bwd_kernel<false><<<nblk, ullava::kRowThreads, smem, st>>>(
        xb, wb, gb, dxb, nullptr, rows, D, rpb, eps);
    return static_cast<int>(cudaGetLastError());
  }
  ullava::rms_bwd_kernel<true><<<nblk, ullava::kRowThreads, smem, st>>>(
      xb, wb, gb, dxb, static_cast<float*>(partial), rows, D, rpb, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ullava::rms_dw_reduce_kernel<<<(D + 31) / 32, 256, 0, st>>>(
      static_cast<const float*>(partial), nblk, D, static_cast<ullava::bf16*>(dw));
  return static_cast<int>(cudaGetLastError());
}
