// fused_rotary: rotate-half rotary embedding over flat [R, H*hd] rows.
//
// Replaces: ullava_tpu/ops/rope.py:95 fused_rotary (Pallas, one VMEM pass
// with two lane rolls and a half mask).
//
// Bound on the card: bytes. Per element it reads x (2 B) and writes the
// output (2 B), plus one fp32 cos/sin row per token shared by all heads;
// about 3 flops per element, far below the H100's 295 flops/byte ridge.
//
// Design: a stream at the memory rate. A block takes one row at a time
// and walks rows with a stride of the grid, which is sized to what the
// SMs hold at once. A thread owns VEC pair positions j..j+VEC-1 of a head
// and their partners j+half..j+half+VEC-1 (a 128-wide head is 8 threads
// at VEC 8): it reads its cos and sin entries of those positions once a
// row into registers and applies them to each head it takes (two at a
// time, so that four 16-byte x loads are in flight beside the table's;
// x stays as loaded until its rotation, and the kernel is held to 64
// registers, so that 8 blocks of 128 threads fit an SM).
// x and the output move VEC bf16 a load or store (16 bytes at VEC 8; 8
// or 4 bytes in the narrower instances that hd % 16 != 0 takes). Index
// math is 32-bit within a row, with no division in the loops. The
// arithmetic is fp32 and only the result is rounded to bf16, as on the
// TPU, which also ignores `rope_f32` and always computes in fp32: out =
// x * c + partner * s, partner = -x[j + half] below half, +x[j - half]
// above it.
#include "common.cuh"

namespace ullava {
namespace rope {

constexpr int kThreads = 128;  // a block, where a row holds that many slots
constexpr int kMaxSlotThreads = 256;

// VEC bf16 of x in one access.
template <int VEC> struct Raw;
template <> struct Raw<8> { using T = uint4; };
template <> struct Raw<4> { using T = uint2; };
template <> struct Raw<2> { using T = uint32_t; };

template <int VEC>
__device__ __forceinline__ typename Raw<VEC>::T load_x(const bf16* p) {
  return *reinterpret_cast<const typename Raw<VEC>::T*>(p);
}

template <int VEC>
__device__ __forceinline__ void load_table(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  }
}

// One head's VEC pairs, kept as loaded until here: lo = x[j..], hi =
// x[j + half..], rotated and stored to out_lo, out_hi.
template <int VEC>
__device__ __forceinline__ void rotate_store(bf16* out_lo, bf16* out_hi,
                                             const typename Raw<VEC>::T& lo,
                                             const typename Raw<VEC>::T& hi,
                                             const float (&c1)[VEC], const float (&c2)[VEC],
                                             const float (&s1)[VEC], const float (&s2)[VEC]) {
  const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lo);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hi);
  typename Raw<VEC>::T rlo, rhi;
  __nv_bfloat162* o_lo = reinterpret_cast<__nv_bfloat162*>(&rlo);
  __nv_bfloat162* o_hi = reinterpret_cast<__nv_bfloat162*>(&rhi);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 a = __bfloat1622float2(l2[i]), b = __bfloat1622float2(h2[i]);
    const int e = 2 * i;
#ifdef ULLAVA_MUTANT_ROPE_PARTNER_SIGN
    // the partner's sign dropped
    o_lo[i] = __float22bfloat162_rn(make_float2(a.x * c1[e] + b.x * s1[e],
                                                a.y * c1[e + 1] + b.y * s1[e + 1]));
#else
    o_lo[i] = __float22bfloat162_rn(make_float2(a.x * c1[e] + (-b.x) * s1[e],
                                                a.y * c1[e + 1] + (-b.y) * s1[e + 1]));
#endif
    o_hi[i] = __float22bfloat162_rn(make_float2(b.x * c2[e] + a.x * s2[e],
                                                b.y * c2[e + 1] + a.y * s2[e + 1]));
  }
  *reinterpret_cast<typename Raw<VEC>::T*>(out_lo) = rlo;
  *reinterpret_cast<typename Raw<VEC>::T*>(out_hi) = rhi;
}

// Block: slot_threads x groups threads. Thread (slot, group) takes pair
// positions slot*VEC + k*slot_threads*VEC (k = 0 where a head has at most
// slot_threads slots) of heads group, group + groups, ...
template <int VEC>
__global__ void __launch_bounds__(kMaxSlotThreads, 4)
rope_kernel(const bf16* __restrict__ x, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, bf16* __restrict__ out, int rows, int heads,
            int head_dim, int slot_threads, int groups) {
  const int half = head_dim / 2;
  const int slots = half / VEC;
  const int width = heads * head_dim;
  const int slot0 = threadIdx.x % slot_threads;
  const int group = threadIdx.x / slot_threads;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
#ifdef ULLAVA_MUTANT_ROPE_FIRST_ROW_TABLE
    const int trow = blockIdx.x;  // the block's first row's table for all its rows
#else
    const int trow = row;
#endif
    const float* crow = cos_t + static_cast<size_t>(trow) * head_dim;
    const float* srow = sin_t + static_cast<size_t>(trow) * head_dim;
    const bf16* xrow = x + static_cast<size_t>(row) * width;
    bf16* orow = out + static_cast<size_t>(row) * width;
    for (int slot = slot0; slot < slots; slot += slot_threads) {
      const int j = slot * VEC;
      float c1[VEC], c2[VEC], s1[VEC], s2[VEC];
      load_table<VEC>(crow + j, c1);
      load_table<VEC>(crow + j + half, c2);
      load_table<VEC>(srow + j, s1);
      load_table<VEC>(srow + j + half, s2);
      for (int h = group; h < heads; h += 2 * groups) {
        const int h2 = h + groups;
        const int o1 = h * head_dim + j, o2 = h2 * head_dim + j;
        typename Raw<VEC>::T a1 = load_x<VEC>(xrow + o1), a2 = load_x<VEC>(xrow + o1 + half);
        typename Raw<VEC>::T b1{}, b2{};
        if (h2 < heads) {
          b1 = load_x<VEC>(xrow + o2);
          b2 = load_x<VEC>(xrow + o2 + half);
        }
        rotate_store<VEC>(orow + o1, orow + o1 + half, a1, a2, c1, c2, s1, s2);
        if (h2 < heads) rotate_store<VEC>(orow + o2, orow + o2 + half, b1, b2, c1, c2, s1, s2);
      }
    }
  }
}

// The widest access that half = head_dim / 2 divides into.
inline int vec_of(int head_dim) {
  const int half = head_dim / 2;
  return half % 8 == 0 ? 8 : half % 4 == 0 ? 4 : 2;
}

// Threads a head's slots take, and head groups, for a block of about
// kThreads threads.
inline void block_shape(int heads, int head_dim, int* slot_threads, int* groups) {
  const int slots = head_dim / 2 / vec_of(head_dim);
  *slot_threads = slots < kMaxSlotThreads ? slots : kMaxSlotThreads;
  const int g = kThreads / *slot_threads;
  *groups = g < 1 ? 1 : g > heads ? heads : g;
}

template <int VEC>
int launch(const void* x, const void* cos_t, const void* sin_t, void* out, int rows, int width,
           int head_dim, cudaStream_t stream) {
  const int heads = width / head_dim;
  int slot_threads, groups;
  block_shape(heads, head_dim, &slot_threads, &groups);
  const int threads = slot_threads * groups;
  // As many blocks as the SMs hold at once (read once a block size), at
  // most one a row; beyond that the blocks walk the rows.
  static int last_threads = 0, per_sm = 0;
  if (threads != last_threads) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rope_kernel<VEC>, threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    last_threads = threads;
  }
  const long long cap = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
  const int grid = static_cast<int>(rows < cap ? rows : cap);
  rope_kernel<VEC><<<grid, threads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<bf16*>(out), rows, heads, head_dim,
      slot_threads, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rope
}  // namespace ullava

// x, out: [rows, width] bf16; cos, sin: [rows, head_dim] fp32.
// width % head_dim == 0, head_dim % 4 == 0 (checked by the wrapper).
ULLAVA_EXPORT int ullava_fused_rotary(const void* x, const void* cos_t,
                                      const void* sin_t, void* out, int rows,
                                      int width, int head_dim, void* stream) {
  if (rows <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ullava::rope::vec_of(head_dim)) {
    case 8: return ullava::rope::launch<8>(x, cos_t, sin_t, out, rows, width, head_dim, s);
    case 4: return ullava::rope::launch<4>(x, cos_t, sin_t, out, rows, width, head_dim, s);
    default: return ullava::rope::launch<2>(x, cos_t, sin_t, out, rows, width, head_dim, s);
  }
}

// {registers, shared bytes, spilled bytes, blocks an SM} of the instance
// that `head_dim` takes, in the block it gets at `width`.
ULLAVA_EXPORT int ullava_fused_rotary_attrs(int width, int head_dim, int* out) {
  int slot_threads, groups;
  ullava::rope::block_shape(width / head_dim, head_dim, &slot_threads, &groups);
  const int threads = slot_threads * groups;
  switch (ullava::rope::vec_of(head_dim)) {
    case 8: return ullava::func_attrs(ullava::rope::rope_kernel<8>, threads, 0, out);
    case 4: return ullava::func_attrs(ullava::rope::rope_kernel<4>, threads, 0, out);
    default: return ullava::func_attrs(ullava::rope::rope_kernel<2>, threads, 0, out);
  }
}
