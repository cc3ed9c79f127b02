// Hopper (sm_90a) building blocks shared by the wgmma + TMA kernels: the
// flash forward (K15 and K2, flash_fwd_sm90.cuh), the flash backward (K16,
// flash_attention_bwd.cu), the SAM global attention core (K11, K20,
// global_sm90.cuh) and the int8 GEMM core (K12, int8_gemm_sm90.cuh).
//
//   - mbarrier helpers (init, expect-tx, arrive, parity wait);
//   - a 4-D TMA tile load completing on an mbarrier's transaction count,
//     and a 4-D TMA reduce-add from shared memory into global memory
//     (bulk groups, with the proxy fence that orders the threads' shared
//     stores before it);
//   - the wgmma descriptor of a 128-byte-swizzled tile whose 8-row groups
//     lie 1024 bytes apart (K-major operands of 128-byte rows: 64 bf16 or
//     128 int8 codes; the transposed V operand: 8 keys of 64 bf16);
//   - the wgmma products the kernels issue: S = Q K^T in bf16
//     (m64n128k16; its first step with write-only registers) and in int8
//     (m64n128k32, s32 sums), O += P V with P
//     from registers (m64n64k16 and m64n16k16, V through the transpose
//     flag), with fence, commit and wait; the m64n64k16 products of the
//     flash backward with both operands in shared memory, either one
//     through its transpose flag;
//   - quad reductions of the accumulator layout and bf16 packing;
//   - the host's tensor-map encoder: cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint, so no library links -lcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums (types only)

#include "common.cuh"

namespace ullava {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One 4-D box of `map` at coordinates (c0, c1, c2, c3) into shared memory,
// completing on `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Adds the 4-D box of fp32 at shared address `src` into `map`'s tensor at
// coordinates (c0, c1, c2, c3), elementwise; parts of the box outside the
// tensor are dropped. Completes as a bulk group (bulk_commit, bulk_wait*).
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map, uint32_t src, int c0,
                                               int c1, int c2, int c3) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.4d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N bulk groups still read their shared source ...
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// ... or are still in flight at all.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Orders this thread's shared-memory stores before later reads of the
// async proxy (a TMA store or reduce, a wgmma operand).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose 8-row
// groups lie 1024 bytes apart, starting at `addr`.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define ULLAVA_F8(d, i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),        \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ULLAVA_FO8(d, i)                                                             \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), "=f"(d[i + 4]),        \
      "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define ULLAVA_R8(d, i)                                                              \
  "=r"(d[i]), "=r"(d[i + 1]), "=r"(d[i + 2]), "=r"(d[i + 3]), "=r"(d[i + 4]),        \
      "=r"(d[i + 5]), "=r"(d[i + 6]), "=r"(d[i + 7])
#define ULLAVA_RR8(d, i)                                                             \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),        \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define ULLAVA_D64                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64] (+)= A (64 x 16, shared) * B (16 x 128, shared, K-major); the sum
// is overwritten when `accumulate` is 0.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ULLAVA_D64 ", "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ULLAVA_F8(d, 0), ULLAVA_F8(d, 8), ULLAVA_F8(d, 16), ULLAVA_F8(d, 24),
        ULLAVA_F8(d, 32), ULLAVA_F8(d, 40), ULLAVA_F8(d, 48), ULLAVA_F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The first 16-deep step of S = Q K^T, overwriting d: its registers are
// outputs only, so the compiler need not keep the last tile's scores (or
// a P packed from them, which a P V in flight reads) where the new ones go.
__device__ __forceinline__ void wgmma_qk_first(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ULLAVA_D64 ", "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ULLAVA_FO8(d, 0), ULLAVA_FO8(d, 8), ULLAVA_FO8(d, 16), ULLAVA_FO8(d, 24),
        ULLAVA_FO8(d, 32), ULLAVA_FO8(d, 40), ULLAVA_FO8(d, 48), ULLAVA_FO8(d, 56)
      : "l"(da), "l"(db), "r"(0));
}

// The int8 form: d[64] = A (64 x 32 int8 codes, shared) * B (32 x 128,
// shared, K-major) in s32, overwriting d (the registers are outputs only,
// so they need not live across the loop) ...
__device__ __forceinline__ void wgmma_qk_s8_first(uint32_t (&d)[64], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " ULLAVA_D64 ", %64, %65, p;\n"
      "}\n"
      : ULLAVA_R8(d, 0), ULLAVA_R8(d, 8), ULLAVA_R8(d, 16), ULLAVA_R8(d, 24),
        ULLAVA_R8(d, 32), ULLAVA_R8(d, 40), ULLAVA_R8(d, 48), ULLAVA_R8(d, 56)
      : "l"(da), "l"(db), "r"(0));
}
// d[64] = A * B, or d[64] += A * B where `accumulate` is not 0: one
// product whose first step of a sum is chosen at run time, with no branch
// between two forms for the compiler to merge registers across.
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " ULLAVA_D64 ", %64, %65, p;\n"
      "}\n"
      : ULLAVA_RR8(d, 0), ULLAVA_RR8(d, 8), ULLAVA_RR8(d, 16), ULLAVA_RR8(d, 24),
        ULLAVA_RR8(d, 32), ULLAVA_RR8(d, 40), ULLAVA_RR8(d, 48), ULLAVA_RR8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// ... and d[64] += A * B for the further 32-deep steps.
__device__ __forceinline__ void wgmma_qk_s8(uint32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " ULLAVA_D64 ", %64, %65, p;\n"
      "}\n"
      : ULLAVA_RR8(d, 0), ULLAVA_RR8(d, 8), ULLAVA_RR8(d, 16), ULLAVA_RR8(d, 24),
        ULLAVA_RR8(d, 32), ULLAVA_RR8(d, 40), ULLAVA_RR8(d, 48), ULLAVA_RR8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

// d[32] += A (64 x 16 from registers, bf16 pairs) * B (16 x 64, shared,
// stored N-major: the transpose flag).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ULLAVA_F8(d, 0), ULLAVA_F8(d, 8), ULLAVA_F8(d, 16), ULLAVA_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[8] += A (64 x 16 from registers) * B (16 x 16, shared, N-major): the
// first 16 columns of a 128-byte-swizzled V half.
__device__ __forceinline__ void wgmma_pv16(float (&d)[8], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : ULLAVA_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define ULLAVA_D32                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[32] += A (64 x 16, shared) * B (16 x 64, shared); TA, TB the transpose
// flags (0: K-major, as Q and K are in S = Q K^T; 1: stored MN-major, as V
// is in O += P V).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ULLAVA_D32 ", "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : ULLAVA_F8(d, 0), ULLAVA_F8(d, 8), ULLAVA_F8(d, 16), ULLAVA_F8(d, 24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The first 16-deep step of such a sum, overwriting d through write-only
// registers (as wgmma_qk_first).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ULLAVA_D32 ", "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : ULLAVA_FO8(d, 0), ULLAVA_FO8(d, 8), ULLAVA_FO8(d, 16), ULLAVA_FO8(d, 24)
      : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

#undef ULLAVA_D32
#undef ULLAVA_F8
#undef ULLAVA_FO8
#undef ULLAVA_R8
#undef ULLAVA_RR8
#undef ULLAVA_D64

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cuTensorMapEncodeTiled, from the driver through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A 4-D tiled view of `ptr`: `dims` innermost first, `strides` the byte
// strides of dims 1-3, read in boxes of `box` elements; elements outside
// the view come in as zeros. False if the driver refuses it.
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                       const cuuint64_t (&dims)[4], const cuuint64_t (&strides)[3],
                       const cuuint32_t (&box)[4], CUtensorMapSwizzle swizzle) {
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace ullava
