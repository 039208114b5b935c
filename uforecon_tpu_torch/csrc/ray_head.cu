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
// only C % 8 == 0 (8 heads, the tensor cores' 8-column tiles).
//
// What bounds it on the H100: arithmetic, as for the point head. At C = 88
// a sample costs ~8.3e4 multiply-adds (the 88x88 and 176x176 layers)
// against 352 bytes in and 4 out, about 460 FLOP per byte.
//
// Design: one block of 512 threads per ray. The ray's SN x C tokens, the
// SN x 2C hidden layer and the per-ray attention state (8 heads x C/8 x C/8
// key-value sums plus the key sums) stay in shared memory for the whole
// chain, rows padded to whole m16 tiles (SNP = SN rounded up to 16) and
// strides to C + 4 / 2C + 4 floats against bank conflicts. The q/k/v/merge,
// mlp1 and mlp2 layers run on the tensor cores in 3xTF32 (tc_gemm.cuh),
// their hi/lo weight planes (pre-split on the host) streamed through a
// two-slot cp.async ring. Shared memory: SNP x (4C + 12) floats + the
// state + the ring; at C = 88 120,960 bytes at SN = 64 and 214,144 at
// SN = 128 (Hopper allows 232,448, so SN <= 128 at C = 88 and <= 160 at
// C = 72, whose SN = 128 takes 175,936).
// Attention is taken in kv order (sum_s phi(k_s) v_s^T once, then one
// C/8 x C/8 product per sample and head), so nothing of size SN x SN is
// formed; the sums run over the SN real samples only, never the padding
// rows. The ray's tokens come in by cp.async, all in flight at once. The
// LayerNorms (tc::layernorm), the attention and the density MLP C -> 32
// -> 16 -> 1 (common.cuh's block_gemm) stay FP32 on the CUDA cores.
//
// What bounds it now (H100, 1024 rays, C = 88, variants timed apart): of
// ~0.58 / ~0.72 ms at SN = 64 / 128, ~0.13 / ~0.22 ms is outside the
// tensor-core layers (the density MLP, the LayerNorms, the kv state and
// the attention, latency-bound between block-wide syncs), the products
// take ~0.25 ms and the operand split, fragment loads and the per-step
// sync the rest; a third ring slot and 256 threads measured slower.
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
//
// kFast (kernel_precision 'fast'): the JAX kernel's single bf16 pass at
// its kernel_dot sites (fused_ray_head.py:85-87, 108-113): the layer
// products (q/k/v, merge, mlp1, mlp2 on tc_gemm.cuh's bf16 mma.m16n8k16,
// the density MLP as block_gemm's FP32 FMAs of bf16-rounded operands) and
// the attention sums kv = sum_s phi(k_s) v_s^T, num = phi(q) kv and den =
// phi(q) ksum, each with both operands rounded to bf16 and the products
// summed in FP32 (ksum itself an FP32 sum). The NeuS epilogue does not
// depend on it, as in JAX.
#include "common.cuh"
#include "tc_gemm.cuh"

namespace ufo {
namespace rh {

constexpr int NH = 8;       // heads
constexpr int D0 = 32, D1 = 16;

// Widths of the token-width-C kernel and the offsets into its packed weight
// buffer, matrices in (in, out) orientation, the tensor-core matrices as a
// TF32 hi plane followed by its lo plane.
template <int C>
struct Width {
  static_assert(C % NH == 0 && C % 8 == 0,
                "C must split into 8 heads and n8 tiles");
  static constexpr int C2 = 2 * C;
  static constexpr int DK = C / NH;  // head width: 11 at C = 88, 9 at C = 72
  static constexpr int LD = tc::act_ld(C);
  static constexpr int LD2 = tc::act_ld(C2);
  static constexpr int O_WQ = 0;
  static constexpr int O_WK = O_WQ + 2 * C * C;
  static constexpr int O_WV = O_WK + 2 * C * C;
  static constexpr int O_WM = O_WV + 2 * C * C;
  static constexpr int O_N1S = O_WM + 2 * C * C;
  static constexpr int O_N1B = O_N1S + C;
  static constexpr int O_W1 = O_N1B + C;
  static constexpr int O_W2 = O_W1 + 2 * C2 * C2;
  static constexpr int O_N2S = O_W2 + 2 * C2 * C;
  static constexpr int O_N2B = O_N2S + C;
  static constexpr int O_DW0 = O_N2B + C;
  static constexpr int O_DB0 = O_DW0 + C * D0;
  static constexpr int O_DW1 = O_DB0 + D0;
  static constexpr int O_DB1 = O_DW1 + D0 * D1;
  static constexpr int O_DW2 = O_DB1 + D1;
  static constexpr int O_DB2 = O_DW2 + D1;
  static constexpr int N_W = O_DB2 + 1;
  static constexpr int kState = NH * DK * DK + C;
  static_assert(O_W1 % 4 == 0 && O_W2 % 4 == 0 && kState % 4 == 0,
                "weight planes and the ring must start 16-byte aligned");
};

// 512 threads: at SN = 128 a block's shared memory leaves room for one
// block per SM, so the block itself must bring the warps
constexpr int kRayThreads = 512;
constexpr int kStages = 2;   // weight ring slots
constexpr int kRowsMax = 128;  // SN up to which the layers take one pass

__host__ __device__ inline int padded_rows(int sn) { return (sn + 15) & ~15; }

template <int C>
inline size_t smem_bytes(int sn) {
  using Wd = Width<C>;
  return sizeof(float) * ((size_t)padded_rows(sn) * (Wd::LD + Wd::LD2 + Wd::LD) +
                          Wd::kState + tc::ring_floats(kStages, Wd::C2));
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

template <int C, bool kNeus, bool kFast>
__global__ void __launch_bounds__(kRayThreads) ray_head_kernel(
    const float* __restrict__ y,   // (RN, SN, C)
    const float* __restrict__ W,   // packed weights, N_W floats
    float* __restrict__ srdf,      // (RN, SN)
    int SN, NeusArgs nz) {
  using Wd = Width<C>;
  constexpr int C2 = Wd::C2, DK = Wd::DK, LD = Wd::LD, LD2 = Wd::LD2;
  // column tiles of a warp's run: one pass over k up to kRowsMax samples
  constexpr int NT_C = tc::col_tiles(kRayThreads / 32, kRowsMax / 16, C);
  constexpr int NT_C2 = tc::col_tiles(kRayThreads / 32, kRowsMax / 16, C2);
  const int SNP = padded_rows(SN);
  const int MTILES = SNP / 16;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // SNP x LD   tokens, later the layer output
  float* A = X + SNP * LD;         // SNP x LD2  keys -> queries/attention -> mlp1
  float* B = A + SNP * LD2;        // SNP x LD   values -> message -> mlp2 out
  float* KV = B + SNP * LD;        // NH x DK x DK: sum_s phi(k_s)[d] v_s[m]
  float* KS = KV + NH * DK * DK;   // C: sum_s phi(k_s)
  float* ring = KS + C;            // weight slots
  const int tid = threadIdx.x;
  const float* yr = y + (size_t)blockIdx.x * SN * C;

  // the ray's tokens by cp.async, all in flight at once; the padding rows
  // are zero, and no sum over samples reads them
  for (int i = tid; i < SN * (C / 4); i += blockDim.x) {
    const int s = i / (C / 4), c4 = i - s * (C / 4);
    tc::cp_async16(X + s * LD + 4 * c4, yr + s * C + 4 * c4);
  }
  tc::cp_async_commit();
  for (int i = tid; i < (SNP - SN) * C; i += blockDim.x)
    X[(SN + i / C) * LD + i % C] = 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();

  // keys -> A, values -> B (each gemm ends in a block-wide sync)
  tc::gemm<kStages, NT_C, kFast>(X, LD, C, nullptr, 0, 0, W + Wd::O_WK, ring,
                                 A, LD, MTILES, C, false);
  tc::gemm<kStages, NT_C, kFast>(X, LD, C, nullptr, 0, 0, W + Wd::O_WV, ring,
                                 B, LD, MTILES, C, false);
  for (int i = tid; i < SN * C; i += blockDim.x) {
    const int j = (i / C) * LD + i % C;
    A[j] = phi(A[j]);
  }
  __syncthreads();

  // per-ray attention state over the SN samples; in kFast the sums of
  // bf16-rounded products, kept bf16-rounded, as the later products take
  // them
  for (int t = tid; t < NH * DK * DK; t += blockDim.x) {
    const int h = t / (DK * DK);
    const int d = (t / DK) % DK;
    const int m = t % DK;
    float acc = 0.f;
    for (int s = 0; s < SN; ++s) {
      const float k = A[s * LD + h * DK + d], v = B[s * LD + h * DK + m];
      acc = kFast ? fmaf(bf16_round(k), bf16_round(v), acc) : fmaf(k, v, acc);
    }
    KV[t] = kFast ? bf16_round(acc) : acc;
  }
  for (int c = tid; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < SN; ++s) acc += A[s * LD + c];
    KS[c] = kFast ? bf16_round(acc) : acc;
  }
  __syncthreads();

  // queries -> A (keys are dead), attention output in place
  tc::gemm<kStages, NT_C, kFast>(X, LD, C, nullptr, 0, 0, W + Wd::O_WQ, ring,
                                 A, LD, MTILES, C, false);
  for (int t = tid; t < SN * NH; t += blockDim.x) {
    const int s = t / NH, h = t - (t / NH) * NH;
    float q[DK];
    float den = 0.f;
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      q[d] = phi(A[s * LD + h * DK + d]);
      if (kFast) q[d] = bf16_round(q[d]);
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
    for (int m = 0; m < DK; ++m) A[s * LD + h * DK + m] = out[m];
  }
  __syncthreads();

  // merge + LayerNorm -> B (values are dead)
  tc::gemm<kStages, NT_C, kFast>(A, LD, C, nullptr, 0, 0, W + Wd::O_WM, ring,
                                 B, LD, MTILES, C, false);
  tc::layernorm<C>(B, LD, SN, W + Wd::O_N1S, W + Wd::O_N1B);
  // mlp1 over [tokens | message] -> A (SNP x LD2)
  tc::gemm<kStages, NT_C2, kFast>(X, LD, C, B, LD, C, W + Wd::O_W1, ring, A, LD2, MTILES, C2, true);
  // mlp2 -> B, LayerNorm added into X (the residual)
  tc::gemm<kStages, NT_C, kFast>(A, LD2, C2, nullptr, 0, 0, W + Wd::O_W2, ring,
                                 B, LD, MTILES, C, false);
  tc::layernorm<C>(B, LD, SN, W + Wd::O_N2S, W + Wd::O_N2B, X, LD);

  // density MLP: C -> 32 -> 16 -> 1
  block_linear<4, kFast>(X, LD, C, W + Wd::O_DW0, W + Wd::O_DB0, A, D0, SN, D0, true);
  __syncthreads();
  block_linear<4, kFast>(A, D0, D0, W + Wd::O_DW1, W + Wd::O_DB1, B, D1, SN, D1, true);
  __syncthreads();
  const size_t r = blockIdx.x;
  if (!kNeus) {
    block_linear<4, kFast>(B, D1, D1, W + Wd::O_DW2, W + Wd::O_DB2, srdf + r * SN, 1, SN, 1,
                    false);
    return;
  }
  // srdf -> A[0, SN) (the hidden layer is dead); A[SN, 5 SN) is scratch
  block_linear<4, kFast>(B, D1, D1, W + Wd::O_DW2, W + Wd::O_DB2, A, 1, SN, 1, false);
  __syncthreads();
  for (int s = tid; s < SN; s += blockDim.x) srdf[r * SN + s] = A[s];
  const float inv_s = fminf(fmaxf(__ldg(nz.inv_s), 1e-6f), 1e6f);
  neus_epilogue(A, A + SN, SN, nz.z + r * SN, nz.rad + r * SN * 3, inv_s,
                nz.weight + r * SN, nz.rgb + r * 3, nz.depth + r, nz.opacity + r);
}

template <int C, bool kNeus, bool kFast>
int launch_c(const float* y, const float* w, float* srdf, int rn, int sn,
             NeusArgs nz, void* stream) {
  const size_t smem = smem_bytes<C>(sn);
  cudaError_t e = cudaFuncSetAttribute(
      ray_head_kernel<C, kNeus, kFast>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ray_head_kernel<C, kNeus, kFast><<<rn, kRayThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(y, w, srdf, sn,
                                                                          nz);
  return (int)cudaGetLastError();
}

// The token widths the kernel is built for, in both precisions.
template <bool kNeus>
int launch(const float* y, const float* w, float* srdf, int rn, int sn, int c,
           bool fast, NeusArgs nz, void* stream) {
  if (rn <= 0) return 0;
  // tc::gemm gives each warp at most one m16 tile
  if (sn <= 0 || sn % 4 || padded_rows(sn) / 16 > kRayThreads / 32)
    return (int)cudaErrorInvalidValue;
  if (c == 88)
    return fast ? launch_c<88, kNeus, true>(y, w, srdf, rn, sn, nz, stream)
                : launch_c<88, kNeus, false>(y, w, srdf, rn, sn, nz, stream);
  if (c == 72)
    return fast ? launch_c<72, kNeus, true>(y, w, srdf, rn, sn, nz, stream)
                : launch_c<72, kNeus, false>(y, w, srdf, rn, sn, nz, stream);
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
// and c (the token width) 72 or 88; fast picks the bf16 instantiation (its
// pack holds bf16 planes).
extern "C" int ufo_ray_head(const float* y, const float* w, float* srdf,
                            int rn, int sn, int c, int fast, void* stream) {
  return ufo::rh::launch<false>(y, w, srdf, rn, sn, c, fast != 0, ufo::rh::NeusArgs{},
                                stream);
}

// The ray head with the NeuS epilogue; the same return, sn and fast rule.
extern "C" int ufo_ray_head_neus(const float* y, const float* w,
                                 const float* z, const float* rad,
                                 const float* inv_s, float* srdf, float* weight,
                                 float* rgb, float* depth, float* opacity,
                                 int rn, int sn, int c, int fast, void* stream) {
  return ufo::rh::launch<true>(
      y, w, srdf, rn, sn, c, fast != 0,
      ufo::rh::NeusArgs{z, rad, inv_s, weight, rgb, depth, opacity}, stream);
}
