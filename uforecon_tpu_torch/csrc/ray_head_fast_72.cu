// Fused along-ray SRDF head for Hopper (sm_90a), kernel_precision 'fast':
// the C 72 instances (the ablation without explicit similarity, and the
// feature grid without the depth guide). The kernel is ray_head_fast.cuh.
#include "ray_head_fast.cuh"

namespace ufo {
namespace rhf {

int launch_c72(const float* y, const float* w, float* srdf, int rn, int sn, bool neus,
               NeusOut nz, cudaStream_t s) {
  return neus ? launch<72, true>(y, w, srdf, rn, sn, nz, s)
              : launch<72, false>(y, w, srdf, rn, sn, nz, s);
}

}  // namespace rhf
}  // namespace ufo
