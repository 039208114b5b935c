// Split-weight per-point view head for Hopper (sm_90a): the 3xTF32 NV
// 6..11 instances (DTU's evaluation set 1 has 11 views), in a file of their own
// so that they compile beside point_head2.cu's NV 2..5. The kernel and its
// tiles are in point_head2.cuh.
#include "point_head2.cuh"

namespace ufo {
namespace ph2 {

template <int CV>
int launch_views(UFO_PH2_ARGS, int nv, int p, cudaStream_t s) {
  static_assert(kMaxViews == 11, "the cases below run to kMaxViews");
  switch (nv) {
    UFO_PH2_CASE(6)
    UFO_PH2_CASE(7)
    UFO_PH2_CASE(8)
    UFO_PH2_CASE(9)
    UFO_PH2_CASE(10)
    UFO_PH2_CASE(11)
    default: return (int)cudaErrorInvalidValue;
  }
}

template int launch_views<24>(UFO_PH2_ARGS, int nv, int p, cudaStream_t s);
template int launch_views<16>(UFO_PH2_ARGS, int nv, int p, cudaStream_t s);

}  // namespace ph2
}  // namespace ufo
