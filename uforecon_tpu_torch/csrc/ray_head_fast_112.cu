// Fused along-ray SRDF head for Hopper (sm_90a), kernel_precision 'fast':
// the C 112 instances (use_dir_srdf; the wide layout (ImgW): mlp1 and the
// density MLP's first two matrices read from the L2). The kernel is
// ray_head_fast.cuh.
#include "ray_head_fast.cuh"

namespace ufo {
namespace rhf {

UFO_RHF_INSTANCES(112)

}  // namespace rhf
}  // namespace ufo
