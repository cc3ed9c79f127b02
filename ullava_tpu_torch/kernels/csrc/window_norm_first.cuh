// Window attention that normalizes P before rounding it to bf16, as the
// TPU's window kernels do (`p = exp(s - m); p = p / sum(p)`, then
// `p.astype(bf16)` for P V): the per-(window, head) kernel
// (`ullava_tpu/ops/sam_attention.py:63-65`; the packed window kernel has
// its own, window_whole.cuh). An online-softmax core rounds the unnormalized P
// against a running maximum instead, which can put an output two bf16
// steps away from the TPU order's; here the rounding points are the TPU
// kernel's, so only fp32 summation order differs.
//
// Design: flash_core.cuh's block shape, fragments and helpers (one block per
// (instance, 64-row q tile), four warps of 16 rows, mma.sync.m16n8k16,
// cp.async double buffering), over a window of at most four 64-key tiles
// (196 keys for 14 x 14), in two loops:
//   1. K tiles stream in; each warp computes its scores (q.k, the
//      decomposed bias from per-block [64, W] tables, the scale, the key
//      mask), keeps the rows' running maximum and sum in fp32, and parks
//      its scores in shared memory (a private [tile][32][thread] slot, so
//      no barrier guards it; 64 KB);
//   2. V tiles stream into the same buffers; each warp reads its scores
//      back, takes p = exp(s - m) / l with the final m and l (an IEEE
//      division), rounds p to bf16 and runs O += P V; O is written as it
//      is, with no final division.
// Loads and products are flash_core.cuh's; the price is one more
// pass of barriers and 64 KB of shared memory (two blocks an SM at
// hd 128 or 80). The bias is added before the scale.
#pragma once

#include "flash_core.cuh"

namespace ullava {

constexpr int kNfTiles = 4;  // key tiles of a window: at most 256 keys

template <int HD, int WB>
constexpr size_t flash_nf_smem_bytes() {
  return sizeof(bf16) * (2 * kBK * (HD + 8) + 2 * kBQ * WB) +
         sizeof(float) * kNfTiles * 32 * kThreads;
}

template <int HD, int WB, class P>
__global__ void __launch_bounds__(kThreads) flash_nf_kernel(const P p) {
  static_assert(HD % 16 == 0 && WB > 0 && WB < kBK, "window forms only");
  constexpr int LD = HD + 8;   // shared-memory row stride (bf16)
  constexpr int KD = HD / 16;  // k-steps of Q K^T
  constexpr int ND = HD / 8;   // 8-wide column tiles of O
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sT = reinterpret_cast<bf16*>(smem_raw);          // [2][kBK][LD]: Q, K tiles, V tiles
  bf16* sBA = sT + 2 * kBK * LD;                          // [kBQ][WB]
  bf16* sBB = sBA + kBQ * WB;                             // [kBQ][WB]
  float* sS = reinterpret_cast<float*>(sBB + kBQ * WB);  // [kNfTiles][32][kThreads] scores

  const int inst = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // row in the 8-row group, thread in quad
  const int Sq = p.Sq, Sk = p.Sk;
  const int lrow0 = warp * 16 + g;  // this thread's local rows: lrow0, lrow0 + 8
  const int row0 = q0 + lrow0, row1 = row0 + 8;

  const bf16* valid = p.q_row(inst, 0);
  bf16* sQ = sT + kBK * LD;  // Q passes through the second stage
  load_tile_async<HD>(sQ, [&](int r) { return q0 + r < Sq ? p.q_row(inst, q0 + r) : nullptr; },
                      valid, tid);
  for (int i = tid; i < kBQ * WB; i += kThreads) {
    const int r = i / WB, j = i % WB;
    const bool live = q0 + r < Sq;
    sBA[i] = __float2bfloat16(live ? p.bias_a(inst, q0 + r, j) : 0.f);
    sBB[i] = __float2bfloat16(live ? p.bias_b(inst, q0 + r, j) : 0.f);
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
  const bool warp_live = q0 + warp * 16 < Sq;  // warps past Sq still take part in the copies
  const int kv_end = p.key_limit(inst);         // <= kNfTiles * kBK (checked at launch)
  const float sl2 = p.scale * kLog2e;           // scores in base-2 units

  auto load = [&](int k0, int stage, bool values) {
    load_tile_async<HD>(sT + stage * kBK * LD, [&](int r) {
      return k0 + r < Sk ? (values ? p.v_row(inst, k0 + r) : p.k_row(inst, k0 + r)) : nullptr;
    }, valid, tid);
  };
  auto wait_tile = [&](int k0, int it, bool values) {  // one group a tile, double-buffered
    if (k0 + kBK < kv_end) {
      load(k0 + kBK, (it + 1) & 1, values);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  __syncthreads();  // every warp holds its Q fragments before stage 1 is reused

  // 1. Scores, each row's maximum and sum.
  if (kv_end > 0) load(0, 0, false);
  for (int k0 = 0, it = 0; k0 < kv_end; k0 += kBK, ++it) {
    wait_tile(k0, it, false);
    const bf16* tK = sT + (it & 1) * kBK * LD;
    const int tile_keys = min(kBK, kv_end - k0);
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
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int t = k0 + j * 8 + tq * 2 + (e & 1);
          const bool ok = (r ? row1 : row0) < Sq && t < kv_end;
          const int lr = lrow0 + r * 8;
          const int tb = ok ? t : 0;  // keep masked keys' table reads in bounds
          const float bias = __bfloat162float(sBA[lr * WB + tb / WB]) +
                             __bfloat162float(sBB[lr * WB + tb % WB]);
          const float x = (s[j][e] + bias) * sl2;
          s[j][e] = ok ? x : -INFINITY;
          mx[r] = fmaxf(mx[r], s[j][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        l_run[r] *= m_new == -INFINITY ? 1.f : exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
      }
      float* dst = sS + it * 32 * kThreads + tid;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          l_run[r] += m_run[r] == -INFINITY ? 0.f : exp2f(s[j][e] - m_run[r]);
          dst[(j * 4 + e) * kThreads] = s[j][e];
        }
      }
    }
    __syncthreads();  // stage it & 1 is refilled at iteration it + 1
  }
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l_run[r]);

  // 2. O = P V with p = exp(s - m) / l rounded to bf16.
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if (kv_end > 0) load(0, 0, true);
  for (int k0 = 0, it = 0; k0 < kv_end; k0 += kBK, ++it) {
    wait_tile(k0, it, true);
    const bf16* tV = sT + (it & 1) * kBK * LD;
    const int tile_keys = min(kBK, kv_end - k0);
    if (warp_live) {
      const float* src = sS + it * 32 * kThreads + tid;
      float pv[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          pv[j][e] = m_run[r] == -INFINITY
                         ? 0.f
                         : __fdiv_rn(exp2f(src[(j * 4 + e) * kThreads] - m_run[r]), l[r]);
        }
      }
      uint32_t pa[4][4];  // P as the A fragments of four 16-key chunks
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pa[c][0] = pack_bf16(pv[2 * c][0], pv[2 * c][1]);
        pa[c][1] = pack_bf16(pv[2 * c][2], pv[2 * c][3]);
        pa[c][2] = pack_bf16(pv[2 * c + 1][0], pv[2 * c + 1][1]);
        pa[c][3] = pack_bf16(pv[2 * c + 1][2], pv[2 * c + 1][3]);
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
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int d = n * 8 + tq * 2;
    if (row0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row0) + d) =
          __floats2bfloat162_rn(o[n][0], o[n][1]);
    if (row1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(p.o_row(inst, row1) + d) =
          __floats2bfloat162_rn(o[n][2], o[n][3]);
  }
}

// Launches one block per (instance, 64-row query tile) on `stream`; a
// window of more than kNfTiles * kBK keys is refused.
template <int HD, int WB, class P>
int launch_flash_norm_first(const P& p, int num_inst, cudaStream_t stream) {
  constexpr size_t smem = flash_nf_smem_bytes<HD, WB>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_nf_kernel<HD, WB, P>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (p.Sk > kNfTiles * kBK) return static_cast<int>(cudaErrorInvalidValue);
  if (num_inst == 0 || p.Sq == 0) return 0;
  dim3 grid(num_inst, (p.Sq + kBQ - 1) / kBQ);
  flash_nf_kernel<HD, WB, P><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ullava
