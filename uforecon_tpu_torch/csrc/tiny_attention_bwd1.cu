// Tiny-sequence elu+1 linear attention for Hopper (sm_90a): the backward
// for rows read in float pieces (D or M odd), in a file of its own so that
// it compiles beside tiny_attention.cu and tiny_attention_bwd2.cu. The
// kernels are in tiny_attention.cuh.
#include "tiny_attention.cuh"

namespace ufo {
namespace ta {

template int launch_bwd_tokens<1>(UFO_TA_BWD_ARGS);

}  // namespace ta
}  // namespace ufo
