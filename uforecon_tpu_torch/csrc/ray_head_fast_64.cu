// Fused along-ray SRDF head for Hopper (sm_90a), kernel_precision 'fast':
// the C 64 instances (the model without a volume (volume_reso 0)). The
// kernel is ray_head_fast.cuh.
#include "ray_head_fast.cuh"

namespace ufo {
namespace rhf {

UFO_RHF_INSTANCES(64)

}  // namespace rhf
}  // namespace ufo
