// Fused along-ray SRDF head for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_head_fused (body _kernel) of the
// JAX package's ops/fused_ray_head.py. Per ray, over its SN z-sorted tokens of
// 88 channels (80 view-token features | 8 order PE):
//   * one LoFTR layer with elu+1 linear attention ACROSS the samples,
//     8 heads x 11, LayerNorm(eps 1e-6), mlp 176 -> 176 -> 88, residual;
//   * density MLP 88 -> 32 -> 16 -> 1, giving the SRDF of each sample.
//
// What bounds it on the H100: arithmetic, as for the point head. A sample
// costs ~8.3e4 FP32 FMAs (the 88x88 and 176x176 layers) against 352 bytes
// in and 4 out, about 460 FLOP per byte; exact FP32 keeps it off the
// tensor cores.
//
// Design: one block of 512 threads per ray. The ray's SN x 88 tokens, the
// SN x 176 hidden layer and the per-ray attention state (8 heads x 11 x 11
// key-value sums plus the key sums) stay in shared memory for the whole
// chain: (352 * SN + 1056) floats, 90 KB at SN = 64 and 180 KB at
// SN = 128. Attention is taken in kv order (sum_s phi(k_s) v_s^T once,
// then one 11x11 product per sample and head), so nothing of size SN x SN
// is formed. Weights (~81k floats) are read through the read-only cache.
#include "common.cuh"

namespace ufo {
namespace rh {

constexpr int C = 88;       // token width
constexpr int C2 = 2 * C;
constexpr int NH = 8;       // heads
constexpr int DK = C / NH;  // head width 11
constexpr int D0 = 32, D1 = 16;

// Offsets into the packed weight buffer, matrices in (in, out) orientation.
constexpr int O_WQ = 0;
constexpr int O_WK = O_WQ + C * C;
constexpr int O_WV = O_WK + C * C;
constexpr int O_WM = O_WV + C * C;
constexpr int O_N1S = O_WM + C * C;
constexpr int O_N1B = O_N1S + C;
constexpr int O_W1 = O_N1B + C;
constexpr int O_W2 = O_W1 + C2 * C2;
constexpr int O_N2S = O_W2 + C2 * C;
constexpr int O_N2B = O_N2S + C;
constexpr int O_DW0 = O_N2B + C;
constexpr int O_DB0 = O_DW0 + C * D0;
constexpr int O_DW1 = O_DB0 + D0;
constexpr int O_DB1 = O_DW1 + D0 * D1;
constexpr int O_DW2 = O_DB1 + D1;
constexpr int O_DB2 = O_DW2 + D1;
constexpr int N_W = O_DB2 + 1;

constexpr int kState = NH * DK * DK + C;
// 512 threads: at SN = 128 a block's shared memory leaves room for one
// block per SM, so the block itself must bring the warps
constexpr int kRayThreads = 512;

inline size_t smem_bytes(int sn) {
  return sizeof(float) * ((size_t)sn * (C + C2 + C) + kState);
}

__global__ void __launch_bounds__(kRayThreads) ray_head_kernel(
    const float* __restrict__ y,   // (RN, SN, C)
    const float* __restrict__ W,   // packed weights, N_W floats
    float* __restrict__ srdf,      // (RN, SN)
    int SN) {
  extern __shared__ float smem[];
  float* X = smem;                 // SN x C   tokens, later the layer output
  float* A = X + SN * C;           // SN x 2C  keys -> queries/attention -> mlp1
  float* B = A + SN * C2;          // SN x C   values -> message -> mlp2 out
  float* KV = B + SN * C;          // NH x DK x DK: sum_s phi(k_s)[d] v_s[m]
  float* KS = KV + NH * DK * DK;   // C: sum_s phi(k_s)
  const int tid = threadIdx.x;
  const float* yr = y + (size_t)blockIdx.x * SN * C;

  for (int i = tid; i < SN * C; i += blockDim.x) X[i] = yr[i];
  __syncthreads();

  // keys -> A, values -> B
  block_linear<4>(X, C, C, W + O_WK, nullptr, A, C, SN, C, false);
  block_linear<4>(X, C, C, W + O_WV, nullptr, B, C, SN, C, false);
  __syncthreads();
  for (int i = tid; i < SN * C; i += blockDim.x) A[i] = phi(A[i]);
  __syncthreads();

  // per-ray attention state
  for (int t = tid; t < NH * DK * DK; t += blockDim.x) {
    const int h = t / (DK * DK);
    const int d = (t / DK) % DK;
    const int m = t % DK;
    float acc = 0.f;
    for (int s = 0; s < SN; ++s)
      acc = fmaf(A[s * C + h * DK + d], B[s * C + h * DK + m], acc);
    KV[t] = acc;
  }
  for (int c = tid; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < SN; ++s) acc += A[s * C + c];
    KS[c] = acc;
  }
  __syncthreads();

  // queries -> A (keys are dead), attention output in place
  block_linear<4>(X, C, C, W + O_WQ, nullptr, A, C, SN, C, false);
  __syncthreads();
  for (int t = tid; t < SN * NH; t += blockDim.x) {
    const int s = t / NH, h = t - (t / NH) * NH;
    float q[DK];
    float den = 0.f;
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      q[d] = phi(A[s * C + h * DK + d]);
      den = fmaf(q[d], KS[h * DK + d], den);
    }
    den += kAttnEps;
    const float* kv = KV + h * DK * DK;
    float out[DK];
#pragma unroll
    for (int m = 0; m < DK; ++m) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) acc = fmaf(q[d], kv[d * DK + m], acc);
      out[m] = acc / den;
    }
#pragma unroll
    for (int m = 0; m < DK; ++m) A[s * C + h * DK + m] = out[m];
  }
  __syncthreads();

  // merge + LayerNorm -> B (values are dead)
  block_linear<4>(A, C, C, W + O_WM, nullptr, B, C, SN, C, false);
  __syncthreads();
  block_layernorm(B, C, SN, C, W + O_N1S, W + O_N1B);
  __syncthreads();
  // mlp1 over [tokens | message] -> A (SN x 2C)
  block_gemm<4>(X, C, C, B, C, C, W + O_W1, nullptr, A, C2, SN, C2, true);
  __syncthreads();
  // mlp2 -> B, LayerNorm, residual into X
  block_linear<4>(A, C2, C2, W + O_W2, nullptr, B, C, SN, C, false);
  __syncthreads();
  block_layernorm(B, C, SN, C, W + O_N2S, W + O_N2B);
  __syncthreads();
  for (int i = tid; i < SN * C; i += blockDim.x) X[i] += B[i];
  __syncthreads();

  // density MLP: 88 -> 32 -> 16 -> 1
  block_linear<4>(X, C, C, W + O_DW0, W + O_DB0, A, D0, SN, D0, true);
  __syncthreads();
  block_linear<4>(A, D0, D0, W + O_DW1, W + O_DB1, B, D1, SN, D1, true);
  __syncthreads();
  block_linear<4>(B, D1, D1, W + O_DW2, W + O_DB2,
                  srdf + (size_t)blockIdx.x * SN, 1, SN, 1, false);
}

}  // namespace rh
}  // namespace ufo

extern "C" int ufo_ray_head_weight_count() { return ufo::rh::N_W; }

extern "C" long long ufo_ray_head_smem_bytes(int sn) {
  return (long long)ufo::rh::smem_bytes(sn);
}

// Returns a cudaError_t value (0 on success). sn must be a multiple of 4.
extern "C" int ufo_ray_head(const float* y, const float* w, float* srdf,
                            int rn, int sn, void* stream) {
  using namespace ufo::rh;
  if (rn <= 0) return 0;
  if (sn <= 0 || sn % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(sn);
  cudaError_t e = cudaFuncSetAttribute(
      ray_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ray_head_kernel<<<rn, kRayThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      y, w, srdf, sn);
  return (int)cudaGetLastError();
}
