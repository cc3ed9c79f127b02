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
// Design: a byte stream with the rows held in registers.
//   - A row belongs to one group of 128 threads (a "slot"); a block holds
//     kSlots slots, and a grid of what the SMs hold walks the rows, slot s
//     of block b taking rows (b + k * grid) * kSlots + s: no one-row tail
//     wave.
//   - Thread t of a slot owns the 8-element vectors t, t + 128, ... of
//     every row (VPT of them, D <= VPT * 1024): it loads x and dy as bf16
//     (16-byte loads, no shared-memory staging) and w once, for every row
//     it walks.
//   - Both row sums, sum(x^2) and sum(dy * w * x), go through one fused
//     two-value reduction: a warp's shuffle tree, then its partial pair
//     into shared memory and one named barrier of the slot's 128 threads;
//     every thread adds the four warps' pairs in warp order. The pairs are
//     double-buffered by row parity, so one barrier a row suffices (a slot
//     reaches row k + 2's writes only after every thread passed row k + 1's
//     barrier, and so after its reads of row k's pairs).
//   - The form without dw issues the next row's x and dy loads before the
//     current row's reduction, so they are in flight across its barrier
//     (kPrefetch). The dw form does not: there the dw sums hold the
//     registers, and prefetch won no clear time in it (PERF.md, K18).
//   - dx is the same arithmetic in both forms, so their dx are bit-equal.
//   - dw: a thread keeps its columns' fp32 sums in registers across its
//     rows; at the end the block's slots are added in slot order through
//     shared memory and the block writes one fp32 partial [D] row; a second
//     kernel of the same entry sums the partial rows column by column in
//     block order: deterministic, no atomics.
//
// Deliberate bugs for the correctness gate, each built only into a copy of
// this source by `chip_smoke.py`:
//   ULLAVA_MUTANT_NO_C           dx without the c term;
//   ULLAVA_MUTANT_RMS_BWD_WARP_OUT the fused reduction leaves out the
//                                slot's last warp's partial pair.
#include <type_traits>

#include "row_quant.cuh"

namespace ullava {
namespace rms_bwd {

constexpr int kSlotThreads = 128;
constexpr int kSlotWarps = kSlotThreads / 32;
constexpr int kMaxVpt = 8;  // D <= 8 * 8 * 128 = 8192

__device__ __forceinline__ float2 warp_sum2(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// The 128 threads of slot `slot` (named barriers 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void slot_sync(int slot) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(slot + 1), "n"(kSlotThreads) : "memory");
}

template <int VPT>
__device__ __forceinline__ void load_row(uint4 (&xv)[VPT], uint4 (&gv)[VPT], const bf16* x,
                                         const bf16* dy, long long base, int t, int vecs) {
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = t + i * kSlotThreads;
    if (v < vecs) {
      xv[i] = *reinterpret_cast<const uint4*>(x + base + v * 8);
      gv[i] = *reinterpret_cast<const uint4*>(dy + base + v * 8);
    }
  }
}

template <int VPT, int kSlots, bool kDw>
__global__ void __launch_bounds__(kSlotThreads* kSlots)
    rms_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ dy, bf16* __restrict__ dx,
                   float* __restrict__ partial, int rows, int D, float eps) {
  constexpr bool kPrefetch = !kDw;
  extern __shared__ float smem[];  // dw: [D] slot exchange
  __shared__ float2 red[kSlots][2][kSlotWarps];
  const int slot = threadIdx.x / kSlotThreads, t = threadIdx.x % kSlotThreads;
  const int warp = t / 32, lane = t % 32;
  const int vecs = D / 8;
  const float inv_d = 1.0f / static_cast<float>(D);

  float wf[VPT][8];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = t + i * kSlotThreads;
    if (v < vecs) load_bf16x8(w + v * 8, wf[i]);
  }
  float acc[VPT][8];  // dw form only
#pragma unroll
  for (int i = 0; i < VPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int stride = gridDim.x * kSlots;
  int row = blockIdx.x * kSlots + slot;
  uint4 xv[VPT], gv[VPT];
  if (kPrefetch && row < rows)
    load_row<VPT>(xv, gv, x, dy, static_cast<long long>(row) * D, t, vecs);
  for (int k = 0; row < rows; ++k, row += stride) {
    const long long base = static_cast<long long>(row) * D;
    if (!kPrefetch) load_row<VPT>(xv, gv, x, dy, base, t, vecs);
    float2 s = make_float2(0.f, 0.f);  // sum x^2, sum dy * w * x
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (t + i * kSlotThreads >= vecs) break;
      float xf[8], gf[8];
      unpack_bf16x8(xv[i], xf);
      unpack_bf16x8(gv[i], gf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s.x += xf[j] * xf[j];
        s.y += gf[j] * wf[i][j] * xf[j];
      }
    }
    uint4 xn[VPT], gn[VPT];
    if (kPrefetch && row + stride < rows)
      load_row<VPT>(xn, gn, x, dy, base + static_cast<long long>(stride) * D, t, vecs);
    s = warp_sum2(s);
    if (lane == 0) red[slot][k & 1][warp] = s;
    slot_sync(slot);
    float2 tot = red[slot][k & 1][0];
#ifdef ULLAVA_MUTANT_RMS_BWD_WARP_OUT
#pragma unroll
    for (int q = 1; q < kSlotWarps - 1; ++q) {
#else
#pragma unroll
    for (int q = 1; q < kSlotWarps; ++q) {
#endif
      const float2 p = red[slot][k & 1][q];
      tot.x += p.x;
      tot.y += p.y;
    }
    const float r = rsqrtf(tot.x * inv_d + eps);
    const float c = tot.y * inv_d;
#ifdef ULLAVA_MUTANT_NO_C
    (void)c;
#endif
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = t + i * kSlotThreads;
      if (v >= vecs) break;
      float xf[8], gf[8], o[8];
      unpack_bf16x8(xv[i], xf);
      unpack_bf16x8(gv[i], gf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#ifdef ULLAVA_MUTANT_NO_C
        o[j] = gf[j] * wf[i][j] * r;
#else
        o[j] = (gf[j] * wf[i][j] - xf[j] * (r * r) * c) * r;
#endif
        if constexpr (kDw) acc[i][j] += gf[j] * xf[j] * r;
      }
      store_bf16x8(dx + base + v * 8, o);
    }
    if (kPrefetch) {
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        xv[i] = xn[i];
        gv[i] = gn[i];
      }
    }
  }
  if constexpr (kDw) {
    // The block's slots added in slot order, then one partial row.
    for (int src = 1; src < kSlots; ++src) {
      __syncthreads();
      if (slot == src) {
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const int v = t + i * kSlotThreads;
          if (v >= vecs) break;
#pragma unroll
          for (int j = 0; j < 8; ++j) smem[v * 8 + j] = acc[i][j];
        }
      }
      __syncthreads();
      if (slot == 0) {
#pragma unroll
        for (int i = 0; i < VPT; ++i) {
          const int v = t + i * kSlotThreads;
          if (v >= vecs) break;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += smem[v * 8 + j];
        }
      }
    }
    if (slot != 0) return;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int v = t + i * kSlotThreads;
      if (v >= vecs) break;
      float4* out =
          reinterpret_cast<float4*>(partial + static_cast<size_t>(blockIdx.x) * D + v * 8);
      out[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      out[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// dw[c] = sum over the nblk partial rows of column c, in block order: a
// block of 256 threads takes 32 columns, eight threads per column each sum
// every eighth partial (their loads unrolled, so several are in flight),
// and one sums their eight results in order.
__global__ void __launch_bounds__(256)
    rms_dw_reduce_kernel(const float* __restrict__ partial, int nblk, int D,
                         bf16* __restrict__ dw) {
  __shared__ float part[8][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + tx;
  float s = 0.f;
  if (c < D) {
#pragma unroll 8
    for (int b = ty; b < nblk; b += 8) s += partial[static_cast<size_t>(b) * D + c];
  }
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && c < D) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += part[i][tx];
    dw[c] = __float2bfloat16(t);
  }
}

// Slots a block: four where registers allow (VPT <= 4), else two.
template <int VPT>
constexpr int slots() {
  return VPT <= 4 ? 4 : 2;
}

template <int VPT, bool kDw>
struct Form {
  static constexpr int kSlots = slots<VPT>();
  static constexpr int kThreads = kSlotThreads * kSlots;

  // Blocks of the form without dw that the card holds at once (read once).
  static int resident_blocks() {
    static int n = 0;
    if (n <= 0) {
      int per_sm = 0;
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, rms_bwd_kernel<VPT, kSlots, kDw>, kThreads, 0) != cudaSuccess ||
          per_sm <= 0)
        per_sm = 1;
      n = per_sm * sm_count();
    }
    return n;
  }

  static int launch(const bf16* x, const bf16* w, const bf16* dy, bf16* dx, float* partial,
                    bf16* dw, int rows, int D, int max_blocks, float eps, cudaStream_t st) {
    // Without dw, what the SMs hold; with it, at most max_blocks partial
    // rows, a count that depends on nothing but the caller's (so dw's sum
    // order is fixed).
    const size_t smem = kDw ? static_cast<size_t>(D) * sizeof(float) : 0;
    const int grid = min((rows + kSlots - 1) / kSlots, kDw ? max_blocks : resident_blocks());
    rms_bwd_kernel<VPT, kSlots, kDw><<<grid, kThreads, smem, st>>>(
        x, w, dy, dx, partial, rows, D, eps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !kDw) return static_cast<int>(err);
    rms_dw_reduce_kernel<<<(D + 31) / 32, 256, 0, st>>>(partial, grid, D, dw);
    return static_cast<int>(cudaGetLastError());
  }

  static int attrs(int D, int* out) {
    return func_attrs(rms_bwd_kernel<VPT, kSlots, kDw>, kThreads,
                      kDw ? static_cast<size_t>(D) * sizeof(float) : 0, out);
  }
};

// Calls `fn(Form<VPT, kDw>{})` for the smallest VPT in {1, 2, 4, 8} that
// covers D.
template <class Fn>
int dispatch(int D, bool dw, Fn&& fn) {
  const int vpt = (D / 8 + kSlotThreads - 1) / kSlotThreads;
  auto by_flags = [&](auto vpt_tag) {
    constexpr int V = decltype(vpt_tag)::value;
    return dw ? fn(Form<V, true>{}) : fn(Form<V, false>{});
  };
  if (vpt <= 1) return by_flags(std::integral_constant<int, 1>{});
  if (vpt <= 2) return by_flags(std::integral_constant<int, 2>{});
  if (vpt <= 4) return by_flags(std::integral_constant<int, 4>{});
  if (vpt <= kMaxVpt) return by_flags(std::integral_constant<int, 8>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rms_bwd
}  // namespace ullava

// x, dy, dx: [rows, D] bf16; w: [D] bf16. With dw (bf16 [D]) non-null,
// partial is [max_blocks, D] f32 scratch, the grid at most max_blocks
// blocks, and a second kernel sums the partial rows into dw; without, both
// are null and max_blocks is ignored. D % 8 == 0 and D <= 8192 (checked by
// the wrapper).
ULLAVA_EXPORT int ullava_rms_norm_bwd(const void* x, const void* w, const void* dy, void* dx,
                                      void* partial, void* dw, int rows, int D, int max_blocks,
                                      float eps, void* stream) {
  using namespace ullava;
  if (rows == 0) return 0;
  return rms_bwd::dispatch(D, dw != nullptr, [&](auto form) {
    return decltype(form)::launch(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const bf16*>(dy),
        static_cast<bf16*>(dx), static_cast<float*>(partial), static_cast<bf16*>(dw), rows, D,
        max_blocks, eps, static_cast<cudaStream_t>(stream));
  });
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the form that
// row width D and `dw` select.
ULLAVA_EXPORT int ullava_rms_norm_bwd_attrs(int D, int dw, int* out) {
  using namespace ullava;
  return rms_bwd::dispatch(D, dw != 0, [&](auto form) { return decltype(form)::attrs(D, out); });
}
