// Fused along-ray SRDF head for Hopper (sm_90a), kernel_precision 'fast':
// the C 88 instances, the entry points and the pack size. The kernel, its
// design and what bounds it are in ray_head_fast.cuh; the C 72 instances in
// ray_head_fast_72.cu.
#include "ray_head_fast.cuh"

namespace ufo {
namespace rhf {

int launch_c88(const float* y, const float* w, float* srdf, int rn, int sn, bool neus,
               NeusOut nz, cudaStream_t s) {
  return neus ? launch<88, true>(y, w, srdf, rn, sn, nz, s)
              : launch<88, false>(y, w, srdf, rn, sn, nz, s);
}

}  // namespace rhf
}  // namespace ufo

namespace {

int launch_any(const float* y, const float* w, float* srdf, int rn, int sn, int c, bool neus,
               ufo::rhf::NeusOut nz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 88) return ufo::rhf::launch_c88(y, w, srdf, rn, sn, neus, nz, s);
  if (c == 72) return ufo::rhf::launch_c72(y, w, srdf, rn, sn, neus, nz, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of the fast kernel's weight pack (fast_image) at token width c (88
// or 72), else -1: a width this kernel does not take.
extern "C" int ufo_ray_head_fast_pack_bytes(int c) {
  using namespace ufo::rhf;
  return c == 88 ? Img<88>::BYTES : c == 72 ? Img<72>::BYTES : -1;
}

// Returns a cudaError_t value (0 on success). c: 88 or 72; sn >= 1; w: the
// pack of ufo_ray_head_fast_pack_bytes(c) bytes, 16-byte aligned.
extern "C" int ufo_ray_head_fast(const float* y, const float* w, float* srdf, int rn, int sn,
                                 int c, void* stream) {
  return launch_any(y, w, srdf, rn, sn, c, false, ufo::rhf::NeusOut{}, stream);
}

// The same with the NeuS epilogue; the same return, c, sn and w rule.
extern "C" int ufo_ray_head_neus_fast(const float* y, const float* w, const float* z,
                                      const float* rad, const float* inv_s, float* srdf,
                                      float* weight, float* rgb, float* depth, float* opacity,
                                      int rn, int sn, int c, void* stream) {
  return launch_any(y, w, srdf, rn, sn, c, true,
                    ufo::rhf::NeusOut{z, rad, inv_s, weight, rgb, depth, opacity}, stream);
}

#ifdef UFO_RHF_PROBE
// the probe's per-phase cycles, phase-2 tiles and rays (ray_head_fast.cuh),
// for the C 88 instances
extern "C" int ufo_ray_head_fast_probe(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, ufo::rhf::rhf_probe, sizeof(ufo::rhf::rhf_probe));
}
#endif
