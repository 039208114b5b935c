// Fused per-point view head for Hopper (sm_90a): the 3xTF32 kernel's NV
// 9..11 instances (DTU's evaluation set 1 has 11 views), in a file of
// their own so that they compile beside the others. The kernel and its
// tiles are in point_head.cuh.
#include "point_head.cuh"

namespace ufo {
namespace ph {

template <int CV>
int launch_views_9_11(UFO_PH_ARGS, int nv, int p, cudaStream_t s) {
  static_assert(kMaxViews == 11, "the cases below run to kMaxViews");
  switch (nv) {
    UFO_PH_CASE(9)
    UFO_PH_CASE(10)
    UFO_PH_CASE(11)
    default: return (int)cudaErrorInvalidValue;
  }
}

template int launch_views_9_11<24>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);
template int launch_views_9_11<16>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);

}  // namespace ph
}  // namespace ufo
