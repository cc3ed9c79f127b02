// The mma.sync online-softmax attention core of the SAM global kernel (K4,
// sam_global_attention.cu); its loads and tensor-core products are also the
// building blocks of flash_attention_bwd.cu, window_norm_first.cuh and
// window_whole.cuh. (The LLaMA prefill and CLIP forward, K2, runs on the
// wgmma + TMA forward of flash_fwd_sm90.cuh.)
//
// A block owns kBQ = 64 query rows of one attention instance (one
// (batch, head) or (image, head) pair): four warps, 16 rows each. Each
// warp keeps its Q rows, its 16 x 64 score tile and its 16 x HD fp32
// output accumulator in registers, in the accumulator layout of the
// tensor-core instruction mma.sync.m16n8k16 (bf16 in, fp32 accumulate),
// so the softmax statistics of a row live in the four threads of a quad
// and need two shuffles per reduction. Per tile of kBK = 64 keys:
//   1. K and V rows stream into shared memory with 16-byte cp.async
//      copies, double-buffered so the next tile loads while this one is
//      computed (rows past the key count are zero-filled; rows padded by
//      16 bytes so ldmatrix reads are bank-conflict free);
//   2. S = Q K^T on the tensor cores (ldmatrix for the K fragments);
//   3. the decomposed rel-pos bias (when WB > 0) is added from per-block
//      [64, WB] tables, the row is scaled and masked, and the running
//      max m and sum l are updated (fp32, base-2 exponentials with the
//      scale folded in);
//   4. P is rounded to bf16 straight from the score registers into the
//      A fragments of the second product (as the TPU kernels round p to
//      v.dtype), O is rescaled by exp(m_old - m_new) and O += P V runs on
//      the tensor cores (ldmatrix.trans for the V fragments).
// A row whose l stays 0 (every key masked) writes zeros.
//
// With EXPBF16 (the serving form of the SAM global kernel) the softmax
// works in natural units and follows the TPU kernel's rounding: s - m is
// rounded to bf16 before the exponential, the probability is rounded to
// bf16, and that rounded value is what l sums (in fp32) and P V uses.
//
// The problem type P supplies the layout: row pointers for q/k/v/o of an
// instance, the key limit, causal masking, and the per-row bias terms.
// With WB = kBK (the 64-wide global grid; WB = 0: no bias) the bias for
// key t = (a, b) = (t / WB, t % WB) of row s is biasA[s][a] + biasB[s][b],
// added to q.k before the scale; both terms are bf16 values, so the tables
// are staged in bf16 without rounding. Every key of a tile shares one row
// a = k0 / W, so the A term is read once per row. Warps whose 16 rows all
// lie past Sq skip the products.
//
// In a tile that ends early (the causal diagonal, kv_lens), the products
// skip the 16-key chunks past the end.
//
// Not yet: TMA, wgmma, warp specialisation.
#pragma once

#include "common.cuh"

namespace ullava {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int HD, int WB>
constexpr size_t flash_smem_bytes() {
  return sizeof(bf16) * (4 * kBK * (HD + 8) + 2 * kBQ * WB);  // 2 stages of K and V
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Starts copying 64 rows of HD bf16 into shared memory (row stride
// HD + 8) with cp.async; `row(r)` returns the source row or nullptr for a
// zero row (a 0-byte copy from `valid`, which zero-fills).
template <int HD, class RowFn>
__device__ __forceinline__ void load_tile_async(bf16* dst, RowFn row, const bf16* valid,
                                                int tid) {
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = tid; i < 64 * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bf16* src = row(r);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * (HD + 8) + c)),
                 "l"(src != nullptr ? src + c : valid), "r"(src != nullptr ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int HD, int WB, class P, bool EXPBF16 = false>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const P p) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(WB == 0 || WB == kBK, "the bias tables hold one grid row a key tile");
  constexpr int LD = HD + 8;  // shared-memory row stride (bf16)
  constexpr int KD = HD / 16;  // k-steps of Q K^T
  constexpr int ND = HD / 8;   // 8-wide column tiles of O

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [2][kBK][LD]
  bf16* sV = sK + 2 * kBK * LD;                   // [2][kBK][LD]
  bf16* sBA = sV + 2 * kBK * LD;                  // [kBQ][WB]
  bf16* sBB = sBA + kBQ * WB;                     // [kBQ][WB]

  const int inst = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // row in the 8-row group, thread in quad
  const int Sq = p.Sq, Sk = p.Sk;
  const int lrow0 = warp * 16 + g;        // this thread's local rows: lrow0, lrow0 + 8
  const int row0 = q0 + lrow0, row1 = row0 + 8;

  const bf16* valid = p.q_row(inst, 0);
  bf16* sQ = sK + kBK * LD;  // Q passes through the second K stage
  load_tile_async<HD>(sQ, [&](int r) { return q0 + r < Sq ? p.q_row(inst, q0 + r) : nullptr; },
                      valid, tid);
  if constexpr (WB > 0) {
    for (int i = tid; i < kBQ * WB; i += kThreads) {
      const int r = i / WB, j = i % WB;
      const bool live = q0 + r < Sq;
      sBA[i] = __float2bfloat16(live ? p.bias_a(inst, q0 + r, j) : 0.f);
      sBB[i] = __float2bfloat16(live ? p.bias_b(inst, q0 + r, j) : 0.f);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  // Warps whose 16 rows all lie past Sq skip the products; they still take
  // part in the copies.
  const bool warp_live = q0 + warp * 16 < Sq;

  const int key_limit = p.key_limit(inst);  // keys >= this are masked
  int kv_end = key_limit;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBQ, Sq) - 1 + p.q_offset + 1);
  constexpr float kLog2e = 1.4426950408889634f;
  // Scores are kept in base-2 units (scale * log2(e) folded in) so that an
  // exponential is one exp2f; with EXPBF16 they stay in natural units,
  // where the TPU kernel rounds them, and `ex` converts.
  const float sl2 = EXPBF16 ? p.scale : p.scale * kLog2e;
  auto ex = [](float d) { return exp2f(EXPBF16 ? d * kLog2e : d); };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  auto load_kv = [&](int k0, int stage) {
    load_tile_async<HD>(sK + stage * kBK * LD,
                        [&](int r) { return k0 + r < Sk ? p.k_row(inst, k0 + r) : nullptr; },
                        valid, tid);
    load_tile_async<HD>(sV + stage * kBK * LD,
                        [&](int r) { return k0 + r < Sk ? p.v_row(inst, k0 + r) : nullptr; },
                        valid, tid);
  };
  __syncthreads();  // every warp holds its Q fragments before stage 1 is reused
  if (kv_end > 0) load_kv(0, 0);
  for (int k0 = 0, it = 0; k0 < kv_end; k0 += kBK, ++it) {
    // Double buffer: tile it+1 streams in while tile it is computed.
    if (k0 + kBK < kv_end) {
      load_kv(k0 + kBK, (it + 1) & 1);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* tK = sK + (it & 1) * kBK * LD;
    const bf16* tV = sV + (it & 1) * kBK * LD;
    const int tile_keys = min(kBK, kv_end - k0);  // keys of this tile the loop must visit
    if (warp_live) {
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // 16 keys per ldmatrix.x4
          if (np * 16 >= tile_keys) break;  // past the last live key: masked anyway
          uint32_t b[4];
          ldmatrix_x4(b, tK + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
      float a_tile[2] = {0.f, 0.f};
      if constexpr (WB == kBK) {
        a_tile[0] = __bfloat162float(sBA[lrow0 * WB + k0 / kBK]);
        a_tile[1] = __bfloat162float(sBA[(lrow0 + 8) * WB + k0 / kBK]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int srow = r ? row1 : row0;
          const int t = k0 + j * 8 + tq * 2 + (e & 1);
          const bool ok = srow < Sq && t < key_limit && (!p.causal || t <= srow + p.q_offset);
          float x = s[j][e];
          if constexpr (WB == kBK) {  // the tile is one key row a = k0 / W
            x += a_tile[r] + __bfloat162float(sBB[(lrow0 + r * 8) * WB + (t - k0)]);
          }
          x *= sl2;
          s[j][e] = ok ? x : -INFINITY;
          mx[r] = fmaxf(mx[r], s[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        alpha[r] = m_new == -INFINITY ? 1.f : ex(m_run[r] - m_new);
        m_run[r] = m_new;
        l_run[r] *= alpha[r];
      }
      uint32_t pa[4][4];  // P as the A fragments of four 16-key chunks
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float d = s[j][e] - m_run[r];
          if constexpr (EXPBF16) d = round_bf16(d);
          float pv = m_run[r] == -INFINITY ? 0.f : ex(d);
          if constexpr (EXPBF16) pv = round_bf16(pv);
          l_run[r] += pv;
          s[j][e] = pv;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pa[c][0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
        pa[c][1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
        pa[c][2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
        pa[c][3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c * 16 >= tile_keys) break;  // P is 0 there
#pragma unroll
        for (int np = 0; np < ND / 2; ++np) {  // 16 output columns per ldmatrix.x4
          uint32_t b[4];
          ldmatrix_x4_trans(b, tV + (c * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD +
                                   np * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * np], pa[c], b[0], b[1]);
          mma_bf16(o[2 * np + 1], pa[c], b[2], b[3]);
        }
      }
    }  // warp_live
    __syncthreads();  // stage it & 1 is refilled at iteration it + 1
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = l == 0.f ? 0.f : 1.f / l;
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + tq * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row0) + d) =
          __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row1) + d) =
          __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

// Launches one block per (instance, 64-row query tile) on `stream`.
template <int HD, int WB, class P, bool EXPBF16 = false>
int launch_flash(const P& p, int num_inst, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD, WB>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD, WB, P, EXPBF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (num_inst == 0 || p.Sq == 0) return 0;
  dim3 grid(num_inst, (p.Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<HD, WB, P, EXPBF16><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ullava
