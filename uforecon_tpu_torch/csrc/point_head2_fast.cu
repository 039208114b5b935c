// Split-weight per-point view head for Hopper (sm_90a), kernel_precision
// 'fast': the C entry points and the NV 2..5 instances. The kernel, its
// design and what bounds it are in point_head2_fast.cuh; the NV 6..11
// instances in point_head2_fast_views.cu. ufo_point_head2 (point_head2.cu)
// sends 'fast' at 2..11 views here.
#include "point_head2_fast.cuh"

namespace ufo {
namespace ph2f {

template <int CV>
int launch(UFO_PH2F_ARGS, int nv, int p, cudaStream_t s) {
  switch (nv) {
    UFO_PH2F_CASE(2)
    UFO_PH2F_CASE(3)
    UFO_PH2F_CASE(4)
    UFO_PH2F_CASE(5)
    default: return launch_views<CV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, nv, p, s);
  }
}

}  // namespace ph2f
}  // namespace ufo

// Bytes of the fast kernel's weight pack (the image and the view token's
// constants) at volume width cv (16 or 24), else -1.
extern "C" int ufo_point_head2_fast_pack_bytes(int cv) {
  using namespace ufo::ph2f;
  return cv == 24 ? Img<24>::PACK : cv == 16 ? Img<16>::PACK : -1;
}

// Returns a cudaError_t value (0 on success). cv (the volume width) must
// be 16 or 24 and nv in 2..11; w is the fast pack
// (ufo_point_head2_fast_pack_bytes).
extern "C" int ufo_point_head2_fast(const float* img, const float* vol, const float* sim,
                                    const float* dd, const float* dir, const float* rgb,
                                    const float* mask, const float* w, float* token, float* rad,
                                    int cv, int nv, int p, void* stream) {
  using namespace ufo::ph2f;
  if (p <= 0) return 0;
  if (nv < 2 || nv > ufo::ph2::kMaxViews) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cv) {
    case 24: return launch<24>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, nv, p, s);
    case 16: return launch<16>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, nv, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef UFO_PH2F_PROBE
// the probe's per-phase cycles and tile count (point_head2_fast.cuh), for
// the NV 2..5 instances
extern "C" int ufo_point_head2_fast_probe(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, ufo::ph2f::ph2f_probe, sizeof(ufo::ph2f::ph2f_probe));
}
#endif
