// Fused per-point view head for Hopper (sm_90a): the 3xTF32 kernel's NV
// 6..8 instances, in a file of their own so that they compile beside
// point_head.cu's NV 2..5 and point_head_views_9_11.cu's NV 9..11 (DTU's
// evaluation set 1 has 11 views). The kernel and its tiles are in
// point_head.cuh.
#include "point_head.cuh"

namespace ufo {
namespace ph {

template <int CV>
int launch_views(UFO_PH_ARGS, int nv, int p, cudaStream_t s) {
  switch (nv) {
    UFO_PH_CASE(6)
    UFO_PH_CASE(7)
    UFO_PH_CASE(8)
    default:
      return launch_views_9_11<CV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, nv, p, s);
  }
}

template int launch_views<24>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);
template int launch_views<16>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);

}  // namespace ph
}  // namespace ufo
