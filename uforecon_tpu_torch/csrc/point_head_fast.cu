// Fused per-point view head for Hopper (sm_90a), kernel_precision 'fast':
// the NV 2..5 instances. The kernel, its design and what bounds it are in
// point_head_fast.cuh; the NV 6..11 instances in point_head_fast_views.cu.
#include "point_head_fast.cuh"

namespace ufo {
namespace ph {

template <int CV>
int launch_fast(UFO_PH_ARGS, int nv, int p, cudaStream_t s) {
  switch (nv) {
    UFO_PHF_CASE(2)
    UFO_PHF_CASE(3)
    UFO_PHF_CASE(4)
    UFO_PHF_CASE(5)
    default:
      return launch_fast_views<CV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, nv, p, s);
  }
}

template int launch_fast<24>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);
template int launch_fast<16>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);

}  // namespace ph
}  // namespace ufo

// Bytes of the fast kernel's weight pack (the image and the view token)
// at volume width cv (16 or 24), else -1.
extern "C" int ufo_point_head_fast_pack_bytes(int cv) {
  using namespace ufo::phf;
  return cv == 24 ? Img<24>::PACK : cv == 16 ? Img<16>::PACK : -1;
}

#ifdef UFO_PHF_PROBE
// the probe's per-phase cycles and tile count (point_head_fast.cuh), for
// the NV 2..5 instances
extern "C" int ufo_point_head_fast_probe(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, ufo::phf::phf_probe, sizeof(ufo::phf::phf_probe));
}
#endif
