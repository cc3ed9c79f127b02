// A bf16 x int8-weight -> fp32 GEMM core for Hopper (sm_90a) on wgmma and
// TMA: the products of the weight-only (w8a8=False) forms of fused_ln_linear
// / fused_linear (K10, ln_linear_wq.cu), fused_ln_linear_dual (K13, both
// weights in one launch, ln_linear_wq.cu) and fused_mlp_block (K12, fc1 and
// fc2, mlp_block_wq.cu).
//
//   y[m, n] = epilogue(sum_k x[m, k] * float(W[k, n]), n)
// x is row-major bf16 [M, K] (row stride lda elements); the weight is the
// port's int8 leaf, stored column-major: Bt[n, k] with K contiguous (row
// stride ldb bytes). Every int8 value is a bf16 value, so widening the
// weight to bf16 is exact and the products are the TPU kernel's bf16 x
// bf16 products with fp32 accumulation.
//
// Design:
//   - The operands are swapped: the block computes the output tile
//     transposed, y^T[n, m] = sum_k Bt[n, k] x[m, k]. The weight rows are
//     wgmma's A operand, from registers, widened from int8 there; the
//     activation rows are its B operand, K-major in shared memory. Neither
//     tensor is re-laid out.
//   - A block owns 128 output channels x 256 tokens: a producer warpgroup
//     (one thread issues every copy; setmaxnreg leaves it 24 registers) and
//     two consumer warpgroups of 64 channels each, each running
//     wgmma.m64n256k16 with its 128 fp32 sums in registers (240 registers
//     a thread). One block an SM.
//   - TMA (sm90.cuh's encoder): a stage is 64 k values, the x box of 256
//     rows x 128 bytes (128-byte swizzle, which wgmma reads) and the weight
//     box of 128 rows x 64 bytes (64-byte swizzle, which makes the consumers'
//     32-bit fragment loads free of bank conflicts); rows past M or N and k
//     past K come in as zeros, so any M, any N that is a multiple of 8 and
//     any K that is a multiple of 16 is taken (row strides and base
//     pointers multiples of 16 bytes). A ring of four 40 KB stages with one
//     full barrier (transaction count) and one empty barrier (8 warp
//     arrivals) a stage.
//   - Consumer loop: a thread widens the 16 A registers of the next stage's
//     four k16 steps while the current stage's four products run, into the
//     other of two register buffers, then waits for the products and
//     releases the stage; so A's registers never change under a product
//     that reads them, and the two warpgroups' products keep the tensor
//     cores busy across each one's wait. A register holds the weight codes
//     of k 2t, 2t+1 of one row (the wgmma A fragment): one prmt puts the two
//     bytes under the bf16 exponent of 128, two lop3 split each code c into
//     128 + (c & 127) and -(128 + (c & 128)), whose bf16 sum (one fma.bf16x2)
//     is c exactly, for all 256 codes.
//   - Epilogue: a thread's sums are 2 channels x 64 tokens. Its per-channel
//     scale and bias are loaded before the products; y = acc * s + b
//     (+ residual) or h = gelu(acc * s + b) in fp32, one rounding to bf16,
//     then stmatrix.trans writes the pairs token-major into a 64 KB tile
//     (two 64-channel halves, 128-byte swizzle), and one TMA store a
//     warpgroup writes its half to the [M, N] output, dropping rows past M
//     and columns past N. The residual tile comes in by TMA into the same
//     shared memory at the block's start, under the products, and each
//     thread reads its pairs with ldmatrix.trans just before it overwrites
//     them.
//   - Two weights, one launch (DualForm, K13): a second weight map (Bt2
//     [N2, K]) adds ceil(N2 / 128) channel tiles after W's ceil(N / 128),
//     as the int8 core's `launch_gemm2` does, so one grid reads the LN'd
//     rows for both. W2's tiles take their own scale and an fp32 bias, and
//     store row-mapped: GEMM row r goes to row r % T of window r / T of the
//     [M / T, rows2, N2] output, and rows with r % T >= rows2 are dropped.
//     No TMA box expresses that map (a TMA store of the whole tile a
//     window, into a 3-D view at a negative row coordinate, stopped the
//     card with an illegal instruction), so W2's tiles leave the shared
//     tile by 16-byte stores, 8 threads a 128-byte token row, each row to
//     its window's place; W's tiles keep the TMA store.
//
// Deliberate bugs, each compiled only into a copy of a source that
// includes this header (`chip_smoke.py` builds them to show that the gates
// catch them):
//   ULLAVA_MUTANT_WQ_UNSIGNED          the weight widened as unsigned bytes;
//   ULLAVA_MUTANT_WQ_BIAS_OFF_BY_ONE   the widening's bias constant one code
//                                      off (every code 1 or 2 too small);
//   ULLAVA_MUTANT_WQ_SCALE_BY_TOKEN    the transposed epilogue's scale indexed
//                                      by token, not by channel;
//   ULLAVA_MUTANT_WQ_DUAL_FIRST_WINDOW W2's tiles stored with the window of
//                                      the tile's first row only.
// Not yet: a persistent tile loop, a 2-CTA cluster that multicasts the x
// tile, 128-token tiles for short inputs (K13's corner class, 256 rows,
// runs 37 blocks on 132 SMs).
#pragma once

#include "gelu_poly.cuh"
#include "sm90.cuh"

namespace ullava {
namespace wq_sm90 {

constexpr int BN = 128;  // output channels a block (weight rows)
constexpr int BT = 256;  // tokens a block (x rows): the wgmma's N
constexpr int BK = 64;   // k values a stage
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kStages = 4;
constexpr uint32_t kTileX = BT * BK * 2;      // 32 KB
constexpr uint32_t kTileW = BN * BK;          // 8 KB
constexpr uint32_t kStage = kTileX + kTileW;  // 40 KB, a multiple of 1 KB
constexpr uint32_t kOutHalf = BT * 128;       // 64 channels x 256 tokens of bf16
constexpr uint32_t kOutOff = kStages * kStage;
constexpr uint32_t kBarOff = kOutOff + 2 * kOutHalf;
constexpr size_t kSmemBytes = 1024 + kBarOff + 8 * (2 * kStages + 1);  // 1 KB to align

// Two int8 codes (bytes 2h, 2h + 1 of w) -> a packed bf16 pair, exactly.
__device__ __forceinline__ uint32_t widen_pair(uint32_t w, uint32_t sel) {
  const uint32_t p = __byte_perm(w, 0x43434343u, sel);  // 0x43 c1 0x43 c0
#ifdef ULLAVA_MUTANT_WQ_UNSIGNED
  const __nv_bfloat162 u = __floats2bfloat162_rn(static_cast<float>(p & 0xffu),
                                                 static_cast<float>((p >> 16) & 0xffu));
  return *reinterpret_cast<const uint32_t*>(&u);
#else
  const uint32_t hi = p & 0xff7fff7fu;  // 128 + (c & 127)
#ifdef ULLAVA_MUTANT_WQ_BIAS_OFF_BY_ONE
  const uint32_t lo = (p & 0x00800080u) | 0xc301c301u;  // -129 or -258
#else
  const uint32_t lo = (p & 0x00800080u) | 0xc300c300u;  // -128 or -256
#endif
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(hi), "r"(0x3f803f80u), "r"(lo));
  return d;
#endif
}

#define ULLAVA_WQ_F8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),             \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ULLAVA_WQ_F32(i) ULLAVA_WQ_F8(i), ULLAVA_WQ_F8(i + 8), ULLAVA_WQ_F8(i + 16), ULLAVA_WQ_F8(i + 24)

// d[128] += A (64 x 16 from registers, bf16 pairs) * B (16 x 256, shared,
// K-major).
__device__ __forceinline__ void wgmma_rs256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : ULLAVA_WQ_F32(0), ULLAVA_WQ_F32(32), ULLAVA_WQ_F32(64), ULLAVA_WQ_F32(96)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ULLAVA_WQ_F32
#undef ULLAVA_WQ_F8

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&v)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// The A registers of one stage's four k16 steps for this thread's rows
// `row` and `row` + 8 of the weight stage `w` ([128 rows][64 bytes], the
// 16-byte chunk c of row r at r * 64 + 16 * (c ^ ((r >> 1) & 3))): f[kk] =
// {row k 2t.., row + 8 k 2t.., row k 2t + 8.., row + 8 k 2t + 8..}.
__device__ __forceinline__ void widen_stage(uint32_t (&f)[4][4], const unsigned char* w, int row,
                                            int tq) {
  const uint32_t sel = (tq & 1) ? 0x4342u : 0x4140u;  // the word's high or low byte pair
  const int swz = (row >> 1) & 3;                    // the same for row + 8
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t* p = reinterpret_cast<const uint32_t*>(w + (row + 8 * r) * BK +
                                                            16 * (kk ^ swz) + 4 * (tq >> 1));
      f[kk][r] = widen_pair(p[0], sel);      // k 2t, 2t + 1
      f[kk][2 + r] = widen_pair(p[2], sel);  // k 2t + 8, 2t + 9
    }
  }
}

// The epilogue forms, the kernel's template argument (their names tell the
// kernels apart in a profile): y = acc * s + b (+ residual) (LinearForm);
// h = gelu(acc * s + b) (GeluForm, fc1 of fused_mlp_block); and the dual
// LN1 + qkv of the windows (DualForm), whose grid holds W's channel tiles
// and then W2's, W2's with its own scale and an fp32 bias, each tile of
// W2's stored row-mapped: GEMM row r to row r % T of window r / T of a
// [M / T, rows2, N2] output, rows with r % T >= rows2 dropped.
struct LinearForm {
  static constexpr bool kGelu = false, kDual = false;
};
struct GeluForm {
  static constexpr bool kGelu = true, kDual = false;
};
struct DualForm {
  static constexpr bool kGelu = false, kDual = true;
};

// What the kernel reads besides its tensor maps. s is fp32 [N], b bf16
// [N], both per channel; DualForm's W2 tiles take s2 [N2] and b2 fp32
// [N2] and write out2. n1 = ceil(N / BN) channel tiles read W, the rest W2.
struct Args {
  const float* ws;
  const bf16* bias;
  const float* ws2;
  const float* bias2;
  bf16* out2;  // DualForm: [M / T, rows2, N2]
  int M, N, N2, K, n1, T, rows2, has_res;
};

template <class Form>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_w2,
                const __grid_constant__ CUtensorMap tm_out,
                const __grid_constant__ CUtensorMap tm_res, const Args a) {
  using namespace sm90;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // 1024-aligned for the swizzles
  auto sX = [&](int s) { return base + s * kStage; };
  auto sW = [&](int s) { return base + s * kStage + kTileX; };
  const uint32_t sOut = base + kOutOff;
  auto full = [&](int s) { return base + kBarOff + 8 * s; };
  auto empty = [&](int s) { return base + kBarOff + 8 * (kStages + s); };
  const uint32_t bar_res = base + kBarOff + 16 * kStages;
  const int KT = (a.K + BK - 1) / BK;
  const bool part = Form::kDual && static_cast<int>(blockIdx.x) >= a.n1;  // a tile of W2's
  const int ch0 = (blockIdx.x - (part ? a.n1 : 0)) * BN, tok0 = blockIdx.y * BT;
  const int N = part ? a.N2 : a.N;
  const bool has_res = !Form::kDual && a.has_res;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    mbar_init(bar_res, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy; the rest of the warpgroup
    // gives its registers back and ends.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const CUtensorMap* tw = part ? &tm_w2 : &tm_w;
      if (has_res) {
        mbar_expect_tx(bar_res, 2 * kOutHalf);
        tma_load(sOut, &tm_res, bar_res, ch0, tok0, 0, 0);
        tma_load(sOut + kOutHalf, &tm_res, bar_res, ch0 + 64, tok0, 0, 0);
      }
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty(s), ((kt / kStages) - 1) & 1);
        mbar_expect_tx(full(s), kStage);
        tma_load(sX(s), &tm_x, full(s), kt * BK, tok0, 0, 0);
        tma_load(sW(s), tw, full(s), kt * BK, ch0, 0, 0);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns channels ch0 + 64 cw .. + 63; a thread's
  // are its wgmma rows g and g + 8.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int row = cw * 64 + warp * 16 + g;  // the first of the two, in the block's 128
  const float* ws = part ? a.ws2 : a.ws;
  float sc[2], bi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ch = ch0 + row + 8 * r;
    sc[r] = ch < N ? ws[ch] : 0.f;
    bi[r] = ch >= N ? 0.f : part ? a.bias2[ch] : __bfloat162float(a.bias[ch]);
  }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t fa[4][4], fb[4][4];  // the A registers of two stages
  const unsigned char* smem = smem_raw + (base - raw);
  // Stage kt's four products from `cur`, the next stage widened into
  // `nxt` while they run, then the stage released.
  auto step = [&](int kt, uint32_t(&cur)[4][4], uint32_t(&nxt)[4][4]) {
    const int s = kt % kStages;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs256(acc, cur[kk], desc_sw128(sX(s) + 32 * kk));
    wgmma_commit();
    if (kt + 1 < KT) {
      const int s1 = (kt + 1) % kStages;
      mbar_wait(full(s1), ((kt + 1) / kStages) & 1);
      widen_stage(nxt, smem + (sW(s1) - base), row, tq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) reg_fence(nxt[kk]);
    }
    wgmma_wait<0>();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(empty(s));
  };
  if (KT > 0) {
    mbar_wait(full(0), 0);
    widen_stage(fa, smem + (sW(0) - base), row, tq);
  }
  for (int kt = 0; kt < KT; kt += 2) {
    step(kt, fa, fb);
    if (kt + 1 < KT) step(kt + 1, fb, fa);
  }

  // Epilogue. Four 8 x 8 pair blocks at a time: block i holds tokens
  // 8 (2 jj + i / 2) .. + 7 and channels 16 warp + 8 (i % 2) .. + 7 of this
  // warpgroup's half; lane l addresses row l % 8 of block l / 8. The half
  // is [256 tokens][128 bytes], chunk c of token t at t * 128 + 16 * (c ^ (t % 8)).
  if (has_res) mbar_wait(bar_res, 0);
  const uint32_t half = sOut + cw * kOutHalf;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int q = lane % 8, bl = lane / 8;
    const int tok = 8 * (2 * jj + bl / 2) + q;
    const uint32_t addr = half + tok * 128 + (((2 * warp + bl % 2) ^ q) << 4);
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (has_res) ldmatrix_x4_trans(v, addr);  // (channel, token pair) as acc holds them
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 2 * jj + i / 2, r = i % 2;
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#ifdef ULLAVA_MUTANT_WQ_SCALE_BY_TOKEN
        const float s = ws[(tok0 + 8 * j + 2 * tq + e) % N];
#else
        const float s = sc[r];
#endif
        const float z = acc[4 * j + 2 * r + e] * s + bi[r];
        if constexpr (Form::kGelu) {
          y[e] = i8::gelu_poly(z);
        } else {
          y[e] = z;
        }
      }
      if (has_res) {
        const float2 res = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[i]));
        y[0] += res.x;
        y[1] += res.y;
      }
      v[i] = pack_bf16(y[0], y[1]);
    }
    stmatrix_x4_trans(addr, v);
  }
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (!part) {
    if (threadIdx.x % 128 == 0 && ch0 + 64 * cw < N) {
      tma_store(&tm_out, half, ch0 + 64 * cw, tok0, 0, 0);
      bulk_commit();
      bulk_wait_read<0>();
    }
  } else {
    // W2's tiles, row-mapped: the warpgroup's 128 threads copy its half
    // out in 16-byte pieces (8 threads a 128-byte token row), GEMM row r to
    // row (r / T) * rows2 + r % T of out2; rows with r % T >= rows2 or past
    // M, and channels past N2, are dropped.
    const unsigned char* tile = smem + (half - base);
    const int c = threadIdx.x % 8, ch = ch0 + 64 * cw + 8 * c;
    for (int t = (threadIdx.x % 128) / 8; t < BT; t += 16) {
      const int tok = tok0 + t;
#ifdef ULLAVA_MUTANT_WQ_DUAL_FIRST_WINDOW
      const int w = tok0 / a.T;  // every row stored with the tile's first window
#else
      const int w = tok / a.T;
#endif
      const int r = tok - w * a.T;
      if (tok < a.M && r < a.rows2 && ch < N)
        *reinterpret_cast<uint4*>(a.out2 + (static_cast<size_t>(w) * a.rows2 + r) * N + ch) =
            *reinterpret_cast<const uint4*>(tile + t * 128 + 16 * (c ^ (t % 8)));
    }
  }
}

// A 2-D tiled view of a row-major [rows, inner] matrix (row stride
// `row_bytes`), read and written in boxes of box_rows x box_inner.
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int inner,
                     int rows, int row_bytes, uint32_t box_inner, uint32_t box_rows,
                     CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows), 1,
                              1};
  const cuuint64_t stride = static_cast<cuuint64_t>(row_bytes);
  const cuuint64_t strides[3] = {stride, stride * rows, stride * rows};
  const cuuint32_t box[4] = {box_inner, box_rows, 1, 1};
  return sm90::encode_map(map, type, ptr, dims, strides, box, swizzle);
}

template <class Form>
int configure() {
  static bool configured = false;
  if (!configured) {
    if (sm90::encode_tiled() == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_kernel<Form>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  return 0;
}

// The kernel's registers, shared bytes, spills and blocks an SM.
template <class Form>
int attrs(int* out) {
  if (const int err = configure<Form>()) return err;
  return func_attrs(gemm_kernel<Form>, kThreads, kSmemBytes, out);
}

// x [M, K] (row stride lda) and the weight W (Bt [N, K], row stride ldb)
// as tensor maps.
inline bool make_operand_maps(CUtensorMap* tm_x, CUtensorMap* tm_w, const bf16* x, int lda, int M,
                              int K, const int8_t* Bt, int ldb, int N) {
  return make_map(tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, lda * 2, BK, BT,
                  CU_TENSOR_MAP_SWIZZLE_128B) &&
         (N == 0 || make_map(tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, Bt, K, N, ldb, BK, BN,
                             CU_TENSOR_MAP_SWIZZLE_64B));
}

// out [M, N] bf16 in 64-channel x 256-token boxes.
inline bool make_out_map(CUtensorMap* map, const bf16* out, int M, int N) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, N, M, N * 2, 64, BT,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// out [M, N] bf16 = epilogue(x [M, K] (row stride lda) @ Bt^T) with the
// per-channel scale ws [N] and bias [N], residual [M, N] or nullptr (not
// with GeluForm), on `stream`, one block a 128-channel x 256-token tile.
// Returns a CUDA error code.
template <class Form>
int launch_gemm(const bf16* x, int lda, int M, const int8_t* Bt, int ldb, int N, int K,
                const float* ws, const bf16* bias, const bf16* residual, bf16* out,
                cudaStream_t stream) {
  static_assert(!Form::kDual, "launch_dual");
  if (const int err = configure<Form>()) return err;
  if (M == 0 || N == 0) return 0;
  CUtensorMap tm_x{}, tm_w{}, tm_out{}, tm_res{};
  if (!make_operand_maps(&tm_x, &tm_w, x, lda, M, K, Bt, ldb, N) ||
      !make_out_map(&tm_out, out, M, N) ||
      (residual != nullptr && !make_out_map(&tm_res, residual, M, N)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{ws, bias, nullptr, nullptr, nullptr, M, N, 0, K, (N + BN - 1) / BN, 1, 0,
               residual != nullptr};
  const dim3 grid(a.n1, (M + BT - 1) / BT);
  gemm_kernel<Form><<<grid, kThreads, kSmemBytes, stream>>>(
      tm_x, tm_w, tm_w, tm_out, residual != nullptr ? tm_res : tm_out, a);
  return static_cast<int>(cudaGetLastError());
}

// The dual product on x [M, K] (row stride K), M = windows * T, in one
// launch: out [M, N] bf16 = x @ Bt^T * ws + bias (bf16), and out2
// [M / T, rows2, N2] bf16 = the leading rows2 rows of every T of x @ Bt2^T
// * ws2 + bias2 (fp32). N or N2 may be 0 (that product left out). A
// template, as launch_gemm is, so that only a source that launches it
// compiles its kernel.
template <class Form>
int launch_dual(const bf16* x, int M, int K, const int8_t* Bt, int N, const float* ws,
                const bf16* bias, bf16* out, const int8_t* Bt2, int N2, const float* ws2,
                const float* bias2, bf16* out2, int T, int rows2, cudaStream_t stream) {
  static_assert(Form::kDual, "launch_gemm");
  if (const int err = configure<Form>()) return err;
  const int n1 = (N + BN - 1) / BN, n2 = (N2 + BN - 1) / BN;
  if (M == 0 || n1 + n2 == 0) return 0;
  CUtensorMap tm_x{}, tm_w{}, tm_w2{}, tm_out{};
  if (!make_operand_maps(&tm_x, &tm_w, x, K, M, K, Bt, K, N) ||
      (N > 0 && !make_out_map(&tm_out, out, M, N)) ||
      (N2 > 0 && !make_map(&tm_w2, CU_TENSOR_MAP_DATA_TYPE_UINT8, Bt2, K, N2, K, BK, BN,
                           CU_TENSOR_MAP_SWIZZLE_64B)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{ws, bias, ws2, bias2, out2, M, N, N2, K, n1, T, rows2, 0};
  const dim3 grid(n1 + n2, (M + BT - 1) / BT);
  gemm_kernel<Form><<<grid, kThreads, kSmemBytes, stream>>>(tm_x, tm_w, tm_w2, tm_out, tm_out, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wq_sm90
}  // namespace ullava
