// Cross-view fusion of the correlation-volume samples for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel volume_fusion_fused (body _kernel) of the
// JAX package's ops/fused_volume_fusion.py, the tail of the correlation-
// volume query. Input: the S = 3 cascade stages' trilinear samples, each
// (NV, P, F + 1) = 8 features || 1 weight, all with the same strides.
// Output (P, S * F), stage-major channels:
//     ws_v = sum_s w_{s,v},   G[p, s F + f] = sum_v f_{s,v,f} ws_v / (sum_v ws_v + 1e-8)
// A point with zero weight in every view gets 0 (0 / 1e-8), never NaN.
// Products and sums are rounded one by one (no FMA) and in the plain
// version's order.
//
// What bounds it on the H100: bytes. At P = 65,536, NV = 3 it reads 21 MB
// and writes 6.3 MB for ~0.3 FLOP per byte.
//
// Design: one thread per point, one pass over the views: a view's summed
// weight is known when its features are read, so the numerators and the
// denominator accumulate together in registers (24 + 1 floats). Threads
// take neighbouring points: on the channel-first layout that F.grid_sample
// gives (strides (9 P, 1, P), which the port's sampler hands over as a view
// without a copy) a warp's reads are 128 contiguous bytes.
#include <cuda_runtime.h>

namespace ufo {
namespace vf {

constexpr int S = 3;   // cascade stages
constexpr int F = 8;   // features per stage
constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;

struct Stages {
  const float* fw[S];
};

__global__ void __launch_bounds__(kThreads) volume_fusion_kernel(
    Stages in, long long sv, long long sp, long long sc,
    float* __restrict__ out,    // (P, S * F) contiguous
    int nv, int p_count) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_count) return;
  float acc[S][F];
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[s][f] = 0.f;
  float den = 0.f;
  for (int v = 0; v < nv; ++v) {
    const long long base = v * sv + p * sp;
    float ws = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) ws = __fadd_rn(ws, __ldg(in.fw[s] + base + F * sc));
    den = __fadd_rn(den, ws);
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int f = 0; f < F; ++f)
        acc[s][f] = __fadd_rn(acc[s][f], __fmul_rn(__ldg(in.fw[s] + base + f * sc), ws));
  }
  den = __fadd_rn(den, kEps);
  float* o = out + (long long)p * (S * F);
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int f = 0; f < F; ++f) o[s * F + f] = __fdiv_rn(acc[s][f], den);
}

}  // namespace vf
}  // namespace ufo

extern "C" int ufo_volume_fusion_stages() { return ufo::vf::S; }
extern "C" int ufo_volume_fusion_features() { return ufo::vf::F; }

// Returns a cudaError_t value (0 on success). fw holds S pointers to
// (NV, P, F + 1) tensors sharing the strides sv, sp, sc (in elements).
extern "C" int ufo_volume_fusion(const float* const* fw, long long sv,
                                 long long sp, long long sc, float* out,
                                 int nv, int p, void* stream) {
  using namespace ufo::vf;
  if (p <= 0) return 0;
  if (nv < 1) return (int)cudaErrorInvalidValue;
  Stages in;
  for (int s = 0; s < S; ++s) in.fw[s] = fw[s];
  const unsigned blocks = (unsigned)((p + kThreads - 1) / kThreads);
  volume_fusion_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, sv, sp, sc, out, nv, p);
  return (int)cudaGetLastError();
}
