// Fused per-point view head for Hopper (sm_90a), kernel_precision 'fast':
// the NV 6..11 instances (DTU's evaluation set 1 has 11 views), whose
// layers add their bf16 products by FP32 FMAs, in a file of their own so
// that they compile beside point_head_fast.cu's NV 2..5. The kernel is in
// point_head_fast.cuh.
#include "point_head_fast.cuh"

namespace ufo {
namespace ph {

template <int CV>
int launch_fast_views(UFO_PH_ARGS, int nv, int p, cudaStream_t s) {
  static_assert(kMaxViews == 11, "the cases below run to kMaxViews");
  switch (nv) {
    UFO_PHF_CASE(6)
    UFO_PHF_CASE(7)
    UFO_PHF_CASE(8)
    UFO_PHF_CASE(9)
    UFO_PHF_CASE(10)
    UFO_PHF_CASE(11)
    default: return (int)cudaErrorInvalidValue;
  }
}

template int launch_fast_views<24>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);
template int launch_fast_views<16>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);

}  // namespace ph
}  // namespace ufo
