// Fused along-ray SRDF head for Hopper (sm_90a), kernel_precision 'fast':
// the C 104 instances (one of the widths config.py's flag sums give; the
// wide layout, ImgW). The kernel is ray_head_fast.cuh.
#include "ray_head_fast.cuh"

namespace ufo {
namespace rhf {

UFO_RHF_INSTANCES(104)

}  // namespace rhf
}  // namespace ufo
