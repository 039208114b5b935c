// Fused along-ray SRDF head for Hopper (sm_90a), kernel_precision 'fast':
// the C 80 instances (no depth positional encoding, or the guided feature
// grid). The kernel is ray_head_fast.cuh.
#include "ray_head_fast.cuh"

namespace ufo {
namespace rhf {

UFO_RHF_INSTANCES(80)

}  // namespace rhf
}  // namespace ufo
