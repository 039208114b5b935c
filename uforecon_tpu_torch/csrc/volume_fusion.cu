// Cross-view fusion of the correlation-volume samples for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volume_fusion_fused (body _kernel) of the
// JAX package's ops/fused_volume_fusion.py, the tail of the correlation-
// volume query. Input: the S = 3 cascade stages' trilinear samples, each
// (NV, P, F + 1) = 8 features || 1 weight, all with the same strides.
// Output (P, S * F), stage-major channels:
//     ws_v = sum_s w_{s,v},   G[p, s F + f] = sum_v f_{s,v,f} ws_v / (sum_v ws_v + 1e-8)
// A point with zero weight in every view gets 0 (0 / 1e-8), never NaN.
// Products, sums and the division are rounded one by one (no FMA, IEEE
// division) and in the plain version's order, so the result is the plain
// version's up to the order of its sums over views.
//
// What bounds it on the H100: bytes. At P = 65,536, NV = 3 it reads 21.2 MB
// and writes 6.3 MB for ~0.3 FLOP per byte: 0.0082 ms at 3.35 TB/s. The
// 27.5 MB fit in the 50 MB L2, and on the main path F.grid_sample writes
// them just before this kernel reads them.
//
// Design: one thread per point, NV a template parameter (1..11: DTU's
// evaluation set 1 has 11 views), so the loop over views unrolls and a
// view's loads no longer wait for the previous view's arithmetic (at
// NV = 3 ptxas keeps 48 registers, so the 81 loads go out in a few
// groups, not all at once). Threads take neighbouring points: on the
// channel-first layout that F.grid_sample gives (strides (9 P, 1, P),
// which the port's sampler hands over as a view without a copy) each load
// of a warp is 128 contiguous bytes. A
// block's output rows are one contiguous run of kThreads x 96 bytes: each
// thread puts its 24 outputs into shared memory as six float4, and the
// block stores the run as coalesced 16-byte stores (a thread's own 24
// scalar stores at a 96-byte stride would touch 32 sectors a warp store;
// float4 stores from registers took 0.0097 ms on the H100 against 0.0063
// staged, script/head_variants.py). Blocks of 64 points (1,024 at P =
// 65,536) spread the points evenly over the 132 SMs.
#include <cuda_runtime.h>

namespace ufo {
namespace vf {

constexpr int S = 3;           // cascade stages
constexpr int F = 8;           // features per stage
constexpr int kMaxViews = 11;  // the largest NV compiled in; above, a runtime count
constexpr int kThreads = 64;   // points a block
constexpr float kEps = 1e-8f;

struct Stages {
  const float* fw[S];
};

template <int NV>
__global__ void __launch_bounds__(kThreads) volume_fusion_kernel(
    Stages in, long long sv, long long sp, long long sc,
    float* __restrict__ out,    // (P, S * F) contiguous, on a 16-byte boundary
    int p_count) {
  __shared__ float4 rows[kThreads * S * F / 4];
  const long long p0 = (long long)blockIdx.x * kThreads;
  const int n = p_count - p0 < kThreads ? (int)(p_count - p0) : kThreads;
  if ((int)threadIdx.x < n) {
    const long long p = p0 + threadIdx.x;
    float w[NV][S], x[NV][S][F];
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float* src = in.fw[s] + v * sv + p * sp;
        w[v][s] = __ldg(src + F * sc);
#pragma unroll
        for (int f = 0; f < F; ++f) x[v][s][f] = __ldg(src + f * sc);
      }
    float ws[NV], den = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      ws[v] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) ws[v] = __fadd_rn(ws[v], w[v][s]);
      den = __fadd_rn(den, ws[v]);
    }
    den = __fadd_rn(den, kEps);
    float o[S * F];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float acc = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) acc = __fadd_rn(acc, __fmul_rn(x[v][s][f], ws[v]));
        o[s * F + f] = __fdiv_rn(acc, den);
      }
    float4* dst = rows + threadIdx.x * (S * F / 4);
#pragma unroll
    for (int j = 0; j < S * F / 4; ++j)
      dst[j] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  }
  __syncthreads();
  // the block's rows, one contiguous run of n x 96 bytes
  float4* run = reinterpret_cast<float4*>(out) + p0 * (S * F / 4);
  for (int i = threadIdx.x; i < n * (S * F / 4); i += kThreads) run[i] = rows[i];
}


// Any NV above kMaxViews: the same sums in the same order with the count
// at run time. A view's weights and features are summed as they arrive,
// so no array grows with NV; the loads of one view no longer overlap the
// next view's arithmetic, which costs time on this rare path only.
__global__ void __launch_bounds__(kThreads) volume_fusion_views_kernel(
    Stages in, long long sv, long long sp, long long sc,
    float* __restrict__ out, int nv, int p_count) {
  __shared__ float4 rows[kThreads * S * F / 4];
  const long long p0 = (long long)blockIdx.x * kThreads;
  const int n = p_count - p0 < kThreads ? (int)(p_count - p0) : kThreads;
  if ((int)threadIdx.x < n) {
    const long long p = p0 + threadIdx.x;
    float acc[S * F], den = 0.f;
#pragma unroll
    for (int j = 0; j < S * F; ++j) acc[j] = 0.f;
    for (int v = 0; v < nv; ++v) {
      float ws = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) ws = __fadd_rn(ws, __ldg(in.fw[s] + v * sv + p * sp + F * sc));
      den = __fadd_rn(den, ws);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float* src = in.fw[s] + v * sv + p * sp;
#pragma unroll
        for (int f = 0; f < F; ++f)
          acc[s * F + f] = __fadd_rn(acc[s * F + f], __fmul_rn(__ldg(src + f * sc), ws));
      }
    }
    den = __fadd_rn(den, kEps);
    float4* dst = rows + threadIdx.x * (S * F / 4);
#pragma unroll
    for (int j = 0; j < S * F / 4; ++j)
      dst[j] = make_float4(__fdiv_rn(acc[4 * j], den), __fdiv_rn(acc[4 * j + 1], den),
                           __fdiv_rn(acc[4 * j + 2], den), __fdiv_rn(acc[4 * j + 3], den));
  }
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out) + p0 * (S * F / 4);
  for (int i = threadIdx.x; i < n * (S * F / 4); i += blockDim.x) dst[i] = rows[i];
}

template <int NV>
int launch(const Stages& in, long long sv, long long sp, long long sc, float* out, int p,
           cudaStream_t stream) {
  const unsigned blocks = (unsigned)((p + kThreads - 1) / kThreads);
  volume_fusion_kernel<NV><<<blocks, kThreads, 0, stream>>>(in, sv, sp, sc, out, p);
  return (int)cudaGetLastError();
}

}  // namespace vf
}  // namespace ufo

extern "C" int ufo_volume_fusion_stages() { return ufo::vf::S; }
extern "C" int ufo_volume_fusion_features() { return ufo::vf::F; }
extern "C" int ufo_volume_fusion_max_views() { return ufo::vf::kMaxViews; }

// Returns a cudaError_t value (0 on success; cudaErrorInvalidValue for NV
// below 1). NV 1..kMaxViews run their compiled-in instance, any larger
// count volume_fusion_views_kernel. fw holds S pointers to (NV, P, F + 1) tensors sharing the
// strides sv, sp, sc (in elements); out starts on a 16-byte boundary.
extern "C" int ufo_volume_fusion(const float* const* fw, long long sv,
                                 long long sp, long long sc, float* out,
                                 int nv, int p, void* stream) {
  using namespace ufo::vf;
  if (nv < 1) return (int)cudaErrorInvalidValue;
  if (p <= 0) return 0;
  Stages in;
  for (int s = 0; s < S; ++s) in.fw[s] = fw[s];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 1: return launch<1>(in, sv, sp, sc, out, p, st);
    case 2: return launch<2>(in, sv, sp, sc, out, p, st);
    case 3: return launch<3>(in, sv, sp, sc, out, p, st);
    case 4: return launch<4>(in, sv, sp, sc, out, p, st);
    case 5: return launch<5>(in, sv, sp, sc, out, p, st);
    case 6: return launch<6>(in, sv, sp, sc, out, p, st);
    case 7: return launch<7>(in, sv, sp, sc, out, p, st);
    case 8: return launch<8>(in, sv, sp, sc, out, p, st);
    case 9: return launch<9>(in, sv, sp, sc, out, p, st);
    case 10: return launch<10>(in, sv, sp, sc, out, p, st);
    case 11: return launch<11>(in, sv, sp, sc, out, p, st);
    default: {
      const unsigned blocks = (unsigned)((p + kThreads - 1) / kThreads);
      volume_fusion_views_kernel<<<blocks, kThreads, 0, st>>>(in, sv, sp, sc, out, nv, p);
      return (int)cudaGetLastError();
    }
  }
}
