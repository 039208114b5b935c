// Fused along-ray SRDF head for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_head_fused (body _kernel) of the
// JAX package's ops/fused_ray_head.py. Per ray, over its SN z-sorted tokens of
// C channels (the view-token features | 8 order PE; C = 88 at the default
// configuration, 72 without explicit similarity):
//   * one LoFTR layer with elu+1 linear attention ACROSS the samples,
//     8 heads x C/8, LayerNorm(eps 1e-6), mlp 2C -> 2C -> C, residual;
//   * density MLP C -> 32 -> 16 -> 1, giving the SRDF of each sample.
// C is a template parameter, instantiated for 72 and 88; the tiling needs
// only C % 8 == 0 (8 heads, 4 output columns per thread).
//
// What bounds it on the H100: arithmetic, as for the point head. At C = 88
// a sample costs ~8.3e4 FP32 FMAs (the 88x88 and 176x176 layers) against
// 352 bytes in and 4 out, about 460 FLOP per byte; exact FP32 keeps it off
// the tensor cores.
//
// Design: one block of 512 threads per ray. The ray's SN x C tokens, the
// SN x 2C hidden layer and the per-ray attention state (8 heads x C/8 x C/8
// key-value sums plus the key sums) stay in shared memory for the whole
// chain: (4C * SN + C^2/8 + C) floats, at C = 88 90 KB at SN = 64 and
// 180 KB at SN = 128, at C = 72 147 KB at SN = 128. Attention is taken in
// kv order (sum_s phi(k_s) v_s^T once, then one C/8 x C/8 product per
// sample and head), so nothing of size SN x SN is formed. Weights (~81k floats at C = 88) are read through the
// read-only cache.
//
// NeuS epilogue (kNeus = true) replaces ray_head_neus_fused (body
// _kernel_neus / _neus_epilogue) of the same JAX file: once the ray's SN
// srdf values are in shared memory, the block composites the ray as
// ops/rendering.py neus_render does (midpoint intervals, sigmoid CDFs at
// srdf +- 0.75 interval, clipped alpha, exclusive product of
// 1 - alpha + 1e-7, weights, rgb / depth / opacity), with z and radiance
// read from global memory. It reuses the dead hidden-layer buffer (5 * SN
// of its 2C * SN floats), so the shared-memory size is the ray head's. The
// product runs serially in one thread, in torch.cumprod's CPU order; the
// JAX kernel's 0/1 matmuls and log-space cumprod were MXU devices.
#include "common.cuh"

namespace ufo {
namespace rh {

constexpr int NH = 8;       // heads
constexpr int D0 = 32, D1 = 16;

// Widths of the token-width-C kernel and the offsets into its packed weight
// buffer, matrices in (in, out) orientation.
template <int C>
struct Width {
  static_assert(C % NH == 0 && C % 4 == 0,
                "C must split into 8 heads and 4-column tiles");
  static constexpr int C2 = 2 * C;
  static constexpr int DK = C / NH;  // head width: 11 at C = 88, 9 at C = 72
  static constexpr int O_WQ = 0;
  static constexpr int O_WK = O_WQ + C * C;
  static constexpr int O_WV = O_WK + C * C;
  static constexpr int O_WM = O_WV + C * C;
  static constexpr int O_N1S = O_WM + C * C;
  static constexpr int O_N1B = O_N1S + C;
  static constexpr int O_W1 = O_N1B + C;
  static constexpr int O_W2 = O_W1 + C2 * C2;
  static constexpr int O_N2S = O_W2 + C2 * C;
  static constexpr int O_N2B = O_N2S + C;
  static constexpr int O_DW0 = O_N2B + C;
  static constexpr int O_DB0 = O_DW0 + C * D0;
  static constexpr int O_DW1 = O_DB0 + D0;
  static constexpr int O_DB1 = O_DW1 + D0 * D1;
  static constexpr int O_DW2 = O_DB1 + D1;
  static constexpr int O_DB2 = O_DW2 + D1;
  static constexpr int N_W = O_DB2 + 1;
  static constexpr int kState = NH * DK * DK + C;
};

// 512 threads: at SN = 128 a block's shared memory leaves room for one
// block per SM, so the block itself must bring the warps
constexpr int kRayThreads = 512;

template <int C>
inline size_t smem_bytes(int sn) {
  return sizeof(float) * ((size_t)sn * (C + Width<C>::C2 + C) + Width<C>::kState);
}

// NeuS compositing of one ray whose srdf values are in S (shared, SN
// floats); T is shared scratch of 4 * SN floats. Mirrors neus_render at
// cos_anneal_ratio 1: next / prev srdf = srdf -/+ 0.75 * interval.
__device__ void neus_epilogue(const float* S, float* T, int SN,
                              const float* __restrict__ z,    // (SN,)
                              const float* __restrict__ rad,  // (SN, 3)
                              float inv_s, float* __restrict__ weight,
                              float* __restrict__ rgb, float* __restrict__ depth,
                              float* __restrict__ opacity) {
  float* Z = T;               // z
  float* F = T + SN;          // alpha, later 1 - alpha + 1e-7
  float* TR = T + 2 * SN;     // exclusive product (transmittance)
  float* WT = T + 3 * SN;     // weight
  const int tid = threadIdx.x;
  for (int s = tid; s < SN; s += blockDim.x) Z[s] = z[s];
  __syncthreads();
  for (int s = tid; s < SN; s += blockDim.x) {
    // neus_render pads the SN - 1 intervals with their first and last and
    // averages neighbours: mid[s] = (iv[max(s-1, 0)] + iv[min(s, SN-2)]) / 2
    const int j0 = s > 0 ? s - 1 : 0;
    const int j1 = s < SN - 2 ? s : SN - 2;
    const float mid = ((Z[j0 + 1] - Z[j0]) + (Z[j1 + 1] - Z[j1])) * 0.5f;
    const float half = (-1.5f * mid) * 0.5f;   // iter_cos * interval * 0.5
    const float next_cdf = 1.f / (1.f + expf(-((S[s] + half) * inv_s)));
    const float prev_cdf = 1.f / (1.f + expf(-((S[s] - half) * inv_s)));
    const float a = fminf(fmaxf(((prev_cdf - next_cdf) + 1e-5f) / (prev_cdf + 1e-5f),
                                0.f), 1.f);
    WT[s] = a;
    F[s] = (1.f - a) + 1e-7f;
  }
  __syncthreads();
  if (tid == 0) {
    float t = 1.f;
    for (int s = 0; s < SN; ++s) {
      TR[s] = t;
      t *= F[s];
    }
  }
  __syncthreads();
  for (int s = tid; s < SN; s += blockDim.x) {
    WT[s] *= TR[s];
    weight[s] = WT[s];
  }
  __syncthreads();
  // five sums over the samples, one warp each: rgb (3), depth, opacity
  const int wid = tid >> 5, lane = tid & 31;
  if (wid < 5) {
    float acc = 0.f;
    for (int s = lane; s < SN; s += 32)
      acc += WT[s] * (wid < 3 ? __ldg(rad + s * 3 + wid) : wid == 3 ? Z[s] : 1.f);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (wid < 3) rgb[wid] = acc;
      else if (wid == 3) *depth = acc;
      else *opacity = acc;
    }
  }
}

// Outputs of the NeuS epilogue, all null when kNeus is false.
struct NeusArgs {
  const float* z;      // (RN, SN)
  const float* rad;    // (RN, SN, 3)
  const float* inv_s;  // () on the device, clamped here to [1e-6, 1e6]
  float* weight;       // (RN, SN)
  float* rgb;          // (RN, 3)
  float* depth;        // (RN,)
  float* opacity;      // (RN,)
};

template <int C, bool kNeus>
__global__ void __launch_bounds__(kRayThreads) ray_head_kernel(
    const float* __restrict__ y,   // (RN, SN, C)
    const float* __restrict__ W,   // packed weights, N_W floats
    float* __restrict__ srdf,      // (RN, SN)
    int SN, NeusArgs nz) {
  using Wd = Width<C>;
  constexpr int C2 = Wd::C2, DK = Wd::DK;
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
  block_linear<4>(X, C, C, W + Wd::O_WK, nullptr, A, C, SN, C, false);
  block_linear<4>(X, C, C, W + Wd::O_WV, nullptr, B, C, SN, C, false);
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
  block_linear<4>(X, C, C, W + Wd::O_WQ, nullptr, A, C, SN, C, false);
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
  block_linear<4>(A, C, C, W + Wd::O_WM, nullptr, B, C, SN, C, false);
  __syncthreads();
  block_layernorm(B, C, SN, C, W + Wd::O_N1S, W + Wd::O_N1B);
  __syncthreads();
  // mlp1 over [tokens | message] -> A (SN x 2C)
  block_gemm<4>(X, C, C, B, C, C, W + Wd::O_W1, nullptr, A, C2, SN, C2, true);
  __syncthreads();
  // mlp2 -> B, LayerNorm, residual into X
  block_linear<4>(A, C2, C2, W + Wd::O_W2, nullptr, B, C, SN, C, false);
  __syncthreads();
  block_layernorm(B, C, SN, C, W + Wd::O_N2S, W + Wd::O_N2B);
  __syncthreads();
  for (int i = tid; i < SN * C; i += blockDim.x) X[i] += B[i];
  __syncthreads();

  // density MLP: 88 -> 32 -> 16 -> 1
  block_linear<4>(X, C, C, W + Wd::O_DW0, W + Wd::O_DB0, A, D0, SN, D0, true);
  __syncthreads();
  block_linear<4>(A, D0, D0, W + Wd::O_DW1, W + Wd::O_DB1, B, D1, SN, D1, true);
  __syncthreads();
  const size_t r = blockIdx.x;
  if (!kNeus) {
    block_linear<4>(B, D1, D1, W + Wd::O_DW2, W + Wd::O_DB2, srdf + r * SN, 1, SN, 1,
                    false);
    return;
  }
  // srdf -> A[0, SN) (the hidden layer is dead); A[SN, 5 SN) is scratch
  block_linear<4>(B, D1, D1, W + Wd::O_DW2, W + Wd::O_DB2, A, 1, SN, 1, false);
  __syncthreads();
  for (int s = tid; s < SN; s += blockDim.x) srdf[r * SN + s] = A[s];
  const float inv_s = fminf(fmaxf(__ldg(nz.inv_s), 1e-6f), 1e6f);
  neus_epilogue(A, A + SN, SN, nz.z + r * SN, nz.rad + r * SN * 3, inv_s,
                nz.weight + r * SN, nz.rgb + r * 3, nz.depth + r, nz.opacity + r);
}

template <int C, bool kNeus>
int launch_c(const float* y, const float* w, float* srdf, int rn, int sn,
             NeusArgs nz, void* stream) {
  const size_t smem = smem_bytes<C>(sn);
  cudaError_t e = cudaFuncSetAttribute(
      ray_head_kernel<C, kNeus>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ray_head_kernel<C, kNeus><<<rn, kRayThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(y, w, srdf, sn, nz);
  return (int)cudaGetLastError();
}

// The token widths the kernel is built for.
template <bool kNeus>
int launch(const float* y, const float* w, float* srdf, int rn, int sn, int c,
           NeusArgs nz, void* stream) {
  if (rn <= 0) return 0;
  if (sn <= 0 || sn % 4) return (int)cudaErrorInvalidValue;
  if (c == 88) return launch_c<88, kNeus>(y, w, srdf, rn, sn, nz, stream);
  if (c == 72) return launch_c<72, kNeus>(y, w, srdf, rn, sn, nz, stream);
  return (int)cudaErrorInvalidValue;
}

inline int weight_count(int c) {
  return c == 88 ? Width<88>::N_W : c == 72 ? Width<72>::N_W : 0;
}

}  // namespace rh
}  // namespace ufo

// 0 for a token width the kernel is not built for.
extern "C" int ufo_ray_head_weight_count(int c) { return ufo::rh::weight_count(c); }

extern "C" long long ufo_ray_head_smem_bytes(int sn, int c) {
  return (long long)(c == 72 ? ufo::rh::smem_bytes<72>(sn) : ufo::rh::smem_bytes<88>(sn));
}

// Returns a cudaError_t value (0 on success). sn must be a multiple of 4
// and c (the token width) 72 or 88.
extern "C" int ufo_ray_head(const float* y, const float* w, float* srdf,
                            int rn, int sn, int c, void* stream) {
  return ufo::rh::launch<false>(y, w, srdf, rn, sn, c, ufo::rh::NeusArgs{}, stream);
}

// The ray head with the NeuS epilogue; the same return and sn rule.
extern "C" int ufo_ray_head_neus(const float* y, const float* w,
                                 const float* z, const float* rad,
                                 const float* inv_s, float* srdf, float* weight,
                                 float* rgb, float* depth, float* opacity,
                                 int rn, int sn, int c, void* stream) {
  return ufo::rh::launch<true>(
      y, w, srdf, rn, sn, c,
      ufo::rh::NeusArgs{z, rad, inv_s, weight, rgb, depth, opacity}, stream);
}
