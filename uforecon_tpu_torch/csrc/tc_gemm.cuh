// Tensor-core block GEMM for the point-head and ray-head kernels (sm_90a).
//
// The contract of common.cuh's block_gemm, without the bias:
//   out[r, c] = act(sum_k a1[r, k] w[k, c] + sum_k a2[r, k] w[k1 + k, c]),
// act none, relu or phi (elu + 1), and optionally a start value per row,
// over a tile of 16 * mtiles rows held in shared memory, on the tensor
// cores with warp-level mma.sync, in one of two precisions (kFast):
//
// 3xTF32 (kernel_precision 'highest' and 'high'), mma.m16n8k8 on TF32:
//   * every operand x is split into two TF32 values, hi = RNA(x) and
//     lo = RNA(x - hi), so x = hi + lo + O(2^-22 |x|);
//   * a * b is taken as lo_a hi_b + hi_a lo_b, then + hi_a hi_b, each
//     accumulated in FP32 registers; lo_a lo_b (~2^-22 |ab|) is dropped.
// The result is accurate to a few FP32 roundings at three TF32 products
// per FP32 product: 495 / 3 = ~165 TFLOP/s against 67 on the CUDA cores.
// RNA (round to nearest, ties away from zero, as cvt.rna.tf32.f32) is two
// integer operations on the float's bits: add half a TF32 ulp to the
// magnitude, clear the 13 bits TF32 drops.
//
// bf16 (kernel_precision 'fast', the JAX package's single bf16 pass),
// mma.m16n8k16 on bf16: the activations rounded to bf16 to nearest even
// (cvt.rn.bf16x2.f32, JAX's astype(bfloat16)), the weights bf16 values
// already; the product of two bf16 values is exact in FP32, so only the
// order of the FP32 sums differs from JAX's. One product per FP32 product
// at the bf16 rate (989 TFLOP/s dense).
//
// bf16 summed by FMAs (kFast with kFmaSum, the streamed point head past 11
// views, as point_head_fast_views.cu sums at NV 6..11): the same bf16 operands, each product added by one FP32 FMA
// on the CUDA cores, k in order from the start value, i.e. the sums of a
// BLAS sgemm kernel that runs k in order (MKL's, measured bit-equal on
// these shapes). The tensor cores' bf16 mma adds its k16 products inside
// the unit, aligned and not rounded to nearest, which moves an output by a
// few FP32 units; at 6 or more views those moves reach the fine pass of a
// fast render often enough to move it beyond the per-ray rule against the
// CPU. Same fragment layout, same ring, same epilogue.
//
// Weights are pre-split on the host: each matrix w (k1 + k2, n), (in,
// out) row-major, is two planes in global memory, hi then lo (3xTF32), or
// its bf16 values then a zero plane (bf16; the values are stored as FP32,
// exactly). They are staged through a ring of shared-memory slots, one k
// step a slot (3xTF32: 8 rows of both planes; bf16: 16 rows of the first,
// rows past k1 + k2 reading the zero plane), filled by cp.async
// kStages - 1 steps ahead, so each weight byte comes from L2 once per
// block and the loads overlap the products of earlier steps. Row strides
// are padded so that the 3xTF32 fragment loads hit 32 distinct banks:
// activations n + 4 floats (an odd multiple of 4 mod 32), weight slots n or
// n + 8 (8 or 24 mod 32). A bf16 k16 step takes its two 8-column halves
// each from a1, a2 or zeros (past k1 + k2), so k1 and k2 need only be
// multiples of 8 in both precisions.
//
// Each warp owns one 16-row tile and a run of up to NT_MAX 8-column tiles
// of the output; warps split the columns of a row tile when there are
// more warps than row tiles. Shapes whose runs exceed NT_MAX take several
// passes over k. (Two row tiles per warp halve the weight fragments each
// product loads, but measured no faster on the H100: the products and
// the operand split set the pace, not shared-memory bandwidth.) Every
// thread of the block calls gemm; it returns with out written and visible
// to the block (it ends in __syncthreads()).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace ufo {
namespace tc {

// Row stride (floats) of an activation buffer n floats wide.
__host__ __device__ constexpr int act_ld(int n) { return n + 4; }
// Row stride of a weight slot n wide.
__host__ __device__ constexpr int w_ld(int n) { return n % 16 == 0 ? n + 8 : n; }
constexpr int kStep = 8;   // weight rows per slot: one k8 step
// Floats of a ring of `stages` slots for layers up to n_max wide.
__host__ __device__ constexpr int ring_floats(int stages, int n_max) {
  return stages * 2 * kStep * w_ld(n_max);
}

__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 in, FP32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, FP32 accumulate. a:
// rows g and g + 8 of k 2t, 2t + 1, then of k 2t + 8, 2t + 9; b: k 2t,
// 2t + 1, then 2t + 8, 2t + 9 of column g; the lower k in the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values of FP32 weights that are bf16 values already (their low
// 16 bits are zero): lo in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Warps of a gemm over mtiles m16 tiles that split a tile's columns.
__host__ __device__ constexpr int warps_per_tile(int nwarps, int mtiles) {
  return nwarps / mtiles > 1 ? nwarps / mtiles : 1;
}
// Column tiles of a warp's run: the NT_MAX that needs one pass over k.
__host__ __device__ constexpr int col_tiles(int nwarps, int mtiles, int n) {
  return (n / 8 + warps_per_tile(nwarps, mtiles) - 1) / warps_per_tile(nwarps, mtiles);
}

// w_hi: the hi plane of w (k1 + k2, n) in global memory, 16-byte aligned,
// the lo plane right after it. ring: ring_floats(kStages, n) floats of
// shared memory, 16-byte aligned. a1, a2 and out: row-major in shared
// memory with strides lda1, lda2, ldo; out must not overlap a1, a2 or the
// ring. k1, k2 and n are multiples of 8 (k2 may be 0), and mtiles is at
// most the block's warp count. act is the epilogue's activation (kNone,
// kRelu, kPhi; false and true name the first two). ldw_global, when set,
// is the planes' row stride in global memory (a multiple of 4): w is then
// a column panel of a wider matrix (k1 + k2, ldw_global), and its lo plane
// starts (k1 + k2) * ldw_global floats after w_hi. cinit, when set, is the
// sums' start: row r of out starts from row (r + c0) / cdiv of cinit
// (stride ldc, in shared memory, not overlapping out), so that rows of
// several views start from their point's shared part (c0: the rows before
// out's first, when out is a later chunk of them).
enum Act { kNone = 0, kRelu = 1, kPhi = 2 };

template <int kStages, int NT_MAX, bool kFast = false, bool kFmaSum = false>
__device__ void gemm(const float* a1, int lda1, int k1,
                     const float* a2, int lda2, int k2,
                     const float* __restrict__ w_hi, float* ring,
                     float* out, int ldo, int mtiles, int n, int act,
                     int ldw_global = 0, const float* cinit = nullptr, int ldc = 0,
                     int cdiv = 1, int c0 = 0) {
  static_assert(kStages >= 2, "the ring needs two slots or more");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma fragment coordinates
  const int ntiles = n >> 3;
  const int wn = warps_per_tile(nwarps, mtiles);
  const int nt = (ntiles + wn - 1) / wn;   // column tiles per warp
  const int mt = warp / wn;                // row tile
  const int my0 = (warp - mt * wn) * nt;
  const int mine = mt < mtiles ? min(nt, ntiles - my0) : 0;
  const int K = k1 + k2;
  constexpr int kK = kFast ? 2 * kStep : kStep;   // k of a step: one mma
  const int steps = (K + kK - 1) / kK;
  const int ldw = w_ld(n);
  const int n4 = n >> 2;
  const int ldg = ldw_global > 0 ? ldw_global : n;
  const float* w_lo = w_hi + (size_t)K * ldg;
  const int row = mt * 16 + g;

  // slot s % kStages <- rows 8s .. 8s + 7 of both planes (3xTF32), or
  // rows 16s .. 16s + 15 of the first (bf16; past K, the zero plane)
  auto load = [&](int s) {
    float* slot = ring + (s % kStages) * 2 * kStep * ldw;
    for (int i = threadIdx.x; i < 2 * kStep * n4; i += blockDim.x) {
      const int r = i / n4, c4 = i - r * n4;          // r < 8: hi, else lo
      const float* src =
          kFast ? w_hi + (size_t)(s * kK + r) * ldg
                : (r < kStep ? w_hi : w_lo) + (size_t)(s * kStep + (r & 7)) * ldg;
      cp_async16(slot + r * ldw + 4 * c4, src + 4 * c4);
    }
  };

  for (int p0 = 0; p0 < nt; p0 += NT_MAX) {   // passes over k
    const int np = min(NT_MAX, mine - p0);     // this warp's tiles in the pass
    float acc[NT_MAX][4];
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      if (cinit != nullptr && j < np) {
        const int col = (my0 + p0 + j) * 8 + 2 * t;
        const float2 top =
            *reinterpret_cast<const float2*>(cinit + ((row + c0) / cdiv) * ldc + col);
        const float2 bot =
            *reinterpret_cast<const float2*>(cinit + ((row + 8 + c0) / cdiv) * ldc + col);
        acc[j][0] = top.x; acc[j][1] = top.y; acc[j][2] = bot.x; acc[j][3] = bot.y;
      }
    }
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) load(s);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();
      // slot s is in for every thread, and every warp is done with step
      // s - 1, whose slot the prefetch below refills
      __syncthreads();
      if (s + kStages - 1 < steps) load(s + kStages - 1);
      cp_async_commit();
      if (np <= 0) continue;
      const float* slot = ring + (s % kStages) * 2 * kStep * ldw;
      if constexpr (kFast && kFmaSum) {
        // each output element (rows g, g + 8; columns 2t, 2t + 1 of each
        // tile) adds its products k by k; a half past k1 + k2 adds nothing
        const float* wb = slot + (my0 + p0) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = s * kK + h * kStep;
          const float* ar = nullptr;
          int lda = 0;
          if (kk < k1) {
            ar = a1 + row * lda1 + kk; lda = lda1;
          } else if (kk < K) {
            ar = a2 + row * lda2 + (kk - k1); lda = lda2;
          }
          if (ar == nullptr) continue;
#pragma unroll
          for (int q = 0; q < kStep; ++q) {
            const float x0 = bf16_round(ar[q]), x1 = bf16_round(ar[8 * lda + q]);
            const float* wr = wb + (h * kStep + q) * ldw;
#pragma unroll
            for (int j = 0; j < NT_MAX; ++j) {
              if (j < np) {
                const float2 w = *reinterpret_cast<const float2*>(wr + j * 8);
                acc[j][0] = fmaf(x0, w.x, acc[j][0]);
                acc[j][1] = fmaf(x0, w.y, acc[j][1]);
                acc[j][2] = fmaf(x1, w.x, acc[j][2]);
                acc[j][3] = fmaf(x1, w.y, acc[j][3]);
              }
            }
          }
        }
      } else if constexpr (kFast) {
        // the step's two 8-column halves of the activations, each from a1,
        // a2 or zeros, rounded to bf16 in pairs
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = s * kK + h * kStep;
          const float* ar = nullptr;
          int lda = 0;
          if (kk < k1) {
            ar = a1 + row * lda1 + kk + 2 * t; lda = lda1;
          } else if (kk < K) {
            ar = a2 + row * lda2 + (kk - k1) + 2 * t; lda = lda2;
          }
          a[2 * h] = ar != nullptr ? bf16x2_rn(ar[0], ar[1]) : 0u;
          a[2 * h + 1] = ar != nullptr ? bf16x2_rn(ar[8 * lda], ar[8 * lda + 1]) : 0u;
        }
        const float* wb = slot + 2 * t * ldw + (my0 + p0) * 8 + g;
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j) {
          if (j < np) {
            const uint32_t b0 = bf16_pair(wb[j * 8], wb[ldw + j * 8]);
            const uint32_t b1 = bf16_pair(wb[8 * ldw + j * 8], wb[9 * ldw + j * 8]);
            mma_bf16(acc[j], a, b0, b1);
          }
        }
      } else {
        const int k = s * kStep;
        const float* a;
        int lda, ka;
        if (k < k1) {
          a = a1; lda = lda1; ka = k;
        } else {
          a = a2; lda = lda2; ka = k - k1;
        }
        const float* ar = a + row * lda + ka + t;
        uint32_t ahi[4], alo[4];
        split(ar[0], ahi[0], alo[0]);
        split(ar[8 * lda], ahi[1], alo[1]);
        split(ar[4], ahi[2], alo[2]);
        split(ar[8 * lda + 4], ahi[3], alo[3]);
        const float* wh = slot + t * ldw + (my0 + p0) * 8 + g;
        const float* wl = wh + kStep * ldw;
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j) {
          if (j < np) {
            const uint32_t bh0 = __float_as_uint(wh[j * 8]);
            const uint32_t bh1 = __float_as_uint(wh[4 * ldw + j * 8]);
            const uint32_t bl0 = __float_as_uint(wl[j * 8]);
            const uint32_t bl1 = __float_as_uint(wl[4 * ldw + j * 8]);
            mma(acc[j], alo, bh0, bh1);
            mma(acc[j], ahi, bl0, bl1);
            mma(acc[j], ahi, bh0, bh1);
          }
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
      if (j < np) {
        const int col = (my0 + p0 + j) * 8 + 2 * t;
        float2 top = make_float2(acc[j][0], acc[j][1]);
        float2 bot = make_float2(acc[j][2], acc[j][3]);
        if (act == kRelu) {
          top.x = fmaxf(top.x, 0.f); top.y = fmaxf(top.y, 0.f);
          bot.x = fmaxf(bot.x, 0.f); bot.y = fmaxf(bot.y, 0.f);
        } else if (act == kPhi) {
          top.x = phi(top.x); top.y = phi(top.y);
          bot.x = phi(bot.x); bot.y = phi(bot.y);
        }
        *reinterpret_cast<float2*>(out + row * ldo + col) = top;
        *reinterpret_cast<float2*>(out + (row + 8) * ldo + col) = bot;
      }
    }
    // the ring is free and out is visible once every warp is here
    __syncthreads();
  }
}

// LayerNorm over the n features of each of `rows` rows of x (stride ld),
// n <= CMAX, the layer chains' other per-row step: common.cuh's
// block_layernorm with the same sums in the same order (one warp per row,
// two-pass mean and variance, eps kLnEps), but each warp reads its lanes'
// scale and bias once and takes two rows at a time, so the L2 round trips
// and the shuffle chains overlap. The result goes back into x, or with
// residual set is added to residual (stride ldr) instead. Ends in
// __syncthreads().
template <int CMAX>
__device__ void layernorm_n(float* x, int ld, int rows, int n,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            float* residual = nullptr, int ldr = 0) {
  constexpr int J = (CMAX + 31) / 32;   // features per lane
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  float sc[J], bi[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    sc[j] = c < n ? __ldg(scale + c) : 0.f;
    bi[j] = c < n ? __ldg(bias + c) : 0.f;
  }
  for (int r0 = 2 * (threadIdx.x >> 5); r0 < rows; r0 += 2 * nwarps) {
    float v[2][J], mean[2], inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        v[h][j] = c < n && r0 + h < rows ? x[(r0 + h) * ld + c] : 0.f;
        if (c < n) s += v[h][j];
      }
      mean[h] = warp_sum(s) / n;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (lane + 32 * j < n) {
          const float d = v[h][j] - mean[h];
          q += d * d;
        }
      }
      inv[h] = rsqrtf(warp_sum(q) / n + kLnEps);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r0 + h >= rows) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c >= n) continue;
        const float y = (v[h][j] - mean[h]) * inv[h] * sc[j] + bi[j];
        if (residual != nullptr) residual[(r0 + h) * ldr + c] += y;
        else x[(r0 + h) * ld + c] = y;
      }
    }
  }
  __syncthreads();
}

// layernorm_n over exactly C features.
template <int C>
__device__ void layernorm(float* x, int ld, int rows, const float* __restrict__ scale,
                          const float* __restrict__ bias, float* residual = nullptr,
                          int ldr = 0) {
  layernorm_n<C>(x, ld, rows, C, scale, bias, residual, ldr);
}

}  // namespace tc
}  // namespace ufo
