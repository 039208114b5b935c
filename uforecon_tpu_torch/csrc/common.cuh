// Block-level building blocks shared by the point-head and ray-head kernels.
//
// Both heads are chains of small dense layers over a tile of rows that
// lives in shared memory. Every routine here is called by all threads of
// the block; callers put __syncthreads() between routines that read what
// another wrote. Math is plain FP32 FMA (no TF32), so results match the
// f32 PyTorch reference up to summation order. In the kernels' bf16
// precision (kernel_precision 'fast', kFast) block_gemm rounds its
// activations to bf16 (to nearest even) and reads weights that are bf16
// values already, keeping the FP32 FMA: the products are exact, as in the
// JAX package's single bf16 pass.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ufo {

constexpr float kAttnEps = 1e-6f;   // linear-attention denominator
constexpr float kLnEps = 1e-6f;     // flax LayerNorm epsilon

__device__ __forceinline__ float phi(float x) {
  // elu(x) + 1
  return x > 0.f ? x + 1.f : expf(x);
}

// Two FP32 values rounded to bf16, to nearest even (JAX's
// astype(bfloat16)), packed with lo in the low half.
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x rounded to bf16, to nearest even, as an FP32 value.
__device__ __forceinline__ float bf16_round(float x) {
  return __uint_as_float(bf16x2_rn(x, 0.f) << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[r, c] = act(bias[c] + sum_k a1[r, k] w[k, c] + sum_k a2[r, k] w[k1 + k, c])
// for r < rows, c < n. a1, a2 and out are row-major with strides lda1,
// lda2, ldo; w is row-major (k1 + k2, n) in global memory (flax (in, out)
// orientation) and read through the read-only cache. Each thread owns an
// RPT x CPT tile: RPT consecutive rows by the CPT columns c, c + n/CPT,
// ..., so each k step costs CPT weight loads (coalesced across the warp)
// and RPT shared-memory broadcasts for RPT * CPT FMAs. Each output is one
// sequential sum over k. rows must be a multiple of RPT and n of CPT; out
// must not overlap a1 or a2. kFast rounds the activations to bf16.
template <int RPT, int CPT, bool kFast>
__device__ __forceinline__ void block_gemm_tiles(
    const float* a1, int lda1, int k1,
    const float* a2, int lda2, int k2,
    const float* __restrict__ w, const float* __restrict__ bias,
    float* out, int ldo, int rows, int n, bool relu) {
  const int ncol = n / CPT;
  const int groups = rows / RPT;
  for (int idx = threadIdx.x; idx < groups * ncol; idx += blockDim.x) {
    const int g = idx / ncol;
    const int c = idx - g * ncol;
    const int r0 = g * RPT;
    float acc[RPT][CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float b = bias != nullptr ? __ldg(bias + c + j * ncol) : 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i][j] = b;
    }
    for (int k = 0; k < k1; ++k) {
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wv[j] = __ldg(w + k * n + c + j * ncol);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = kFast ? bf16_round(a1[(r0 + i) * lda1 + k]) : a1[(r0 + i) * lda1 + k];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
    for (int k = 0; k < k2; ++k) {
      float wv[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wv[j] = __ldg(w + (k1 + k) * n + c + j * ncol);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = kFast ? bf16_round(a2[(r0 + i) * lda2 + k]) : a2[(r0 + i) * lda2 + k];
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        out[(r0 + i) * ldo + c + j * ncol] = relu ? fmaxf(acc[i][j], 0.f) : acc[i][j];
  }
}

// block_gemm_tiles with 4 columns per thread where n allows it.
template <int RPT, bool kFast = false>
__device__ __forceinline__ void block_gemm(
    const float* a1, int lda1, int k1,
    const float* a2, int lda2, int k2,
    const float* __restrict__ w, const float* __restrict__ bias,
    float* out, int ldo, int rows, int n, bool relu) {
  if (n % 4 == 0)
    block_gemm_tiles<RPT, 4, kFast>(a1, lda1, k1, a2, lda2, k2, w, bias, out, ldo, rows, n,
                                    relu);
  else
    block_gemm_tiles<RPT, 1, kFast>(a1, lda1, k1, a2, lda2, k2, w, bias, out, ldo, rows, n,
                                    relu);
}

template <int RPT, bool kFast = false>
__device__ __forceinline__ void block_linear(
    const float* a, int lda, int k, const float* __restrict__ w,
    const float* __restrict__ bias, float* out, int ldo, int rows, int n,
    bool relu) {
  block_gemm<RPT, kFast>(a, lda, k, nullptr, 0, 0, w, bias, out, ldo, rows, n, relu);
}

// In-place LayerNorm over the n features of each of `rows` rows; one warp
// per row, two-pass mean and variance.
__device__ __forceinline__ void block_layernorm(
    float* x, int ld, int rows, int n,
    const float* __restrict__ scale, const float* __restrict__ bias) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < rows; r += nwarps) {
    float* row = x + r * ld;
    float s = 0.f;
    for (int c = lane; c < n; c += 32) s += row[c];
    const float mean = warp_sum(s) / n;
    float v = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float d = row[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / n + kLnEps);
    for (int c = lane; c < n; c += 32)
      row[c] = (row[c] - mean) * inv * __ldg(scale + c) + __ldg(bias + c);
  }
}

}  // namespace ufo
