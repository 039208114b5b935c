// Grouped pairwise cosine similarity for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel grouped_cosine_fused (body _kernel) of the
// JAX package's ops/fused_similarity.py, the tail of the explicit-
// similarity query. Input: the pair-map samples, (NV, P, (NV-1) * C) with
// any strides; view v's row holds its NV - 1 pair maps in pair order. For
// each view pair (i, j), i < j, in lexicographic order, the C channels of
// the pair's map in view i and in view j are split into G groups, and the
// output is the mean over pairs of dot / max(|a| |b|, 1e-8) per group
// (torch CosineSimilarity's eps), (P, G).
//
// Slots: the earlier pairs that involve view i are (a, i) for a < i and
// (i, b) for i < b < j, so pair (i, j) sits at slot j - 1 of view i's row;
// in view j's row the earlier ones are (a, j), a < i, so it sits at slot i.
//
// What bounds it on the H100: bytes. At P = 65,536, NV = 3, C = 32 it
// reads 50 MB and writes 2 MB for ~1.3 FLOP per byte.
//
// Design: one thread per (point, group), points fastest, so a warp reads 32
// neighbouring points of one channel. The port's sampler hands over the
// channel-first layout that F.grid_sample gives, strides (C' P, 1, P), as a
// view without a copy: there those reads are 128 contiguous bytes. Any
// other strides give the same result, with scattered reads.
#include <cuda_runtime.h>

namespace ufo {
namespace gc {

constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;

__global__ void __launch_bounds__(kThreads) grouped_cosine_kernel(
    const float* __restrict__ x, long long sv, long long sp, long long sc,
    float* __restrict__ out,      // (P, G) contiguous
    int nv, int p_count, int c, int g_count) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)p_count * g_count) return;
  const int p = (int)(t % p_count);
  const int g = (int)(t / p_count);
  const int gs = c / g_count;
  const float* xp = x + p * sp + (long long)g * gs * sc;
  float acc = 0.f;
  int n_pairs = 0;
  for (int i = 0; i < nv - 1; ++i) {
    for (int j = i + 1; j < nv; ++j) {
      const float* a = xp + i * sv + (long long)(j - 1) * c * sc;
      const float* b = xp + j * sv + (long long)i * c * sc;
      float dot = 0.f, na = 0.f, nb = 0.f;
      for (int e = 0; e < gs; ++e) {
        const float av = __ldg(a + e * sc);
        const float bv = __ldg(b + e * sc);
        dot += av * bv;
        na += av * av;
        nb += bv * bv;
      }
      acc += dot / fmaxf(sqrtf(na) * sqrtf(nb), kEps);
      ++n_pairs;
    }
  }
  out[(long long)p * g_count + g] = acc / (float)n_pairs;
}

}  // namespace gc
}  // namespace ufo

// Returns a cudaError_t value (0 on success). Strides are in elements;
// c must be a multiple of g_count and nv >= 2.
extern "C" int ufo_grouped_cosine(const float* x, long long sv, long long sp,
                                  long long sc, float* out, int nv, int p,
                                  int c, int g, void* stream) {
  using namespace ufo::gc;
  if (p <= 0) return 0;
  if (nv < 2 || g <= 0 || c % g) return (int)cudaErrorInvalidValue;
  const long long n = (long long)p * g;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  grouped_cosine_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, sv, sp, sc, out, nv, p, c, g);
  return (int)cudaGetLastError();
}
