// Split-weight per-point view head for Hopper (sm_90a): the C entry points
// and the 3xTF32 NV 2..5 instances. The kernel, its design and what bounds
// it are in point_head2.cuh; the NV 6..11 instances in
// point_head2_views.cu; the fast kernel at NV 2..11 in point_head2_fast.cuh;
// any count past 11, both precisions, in point_head2_stream.cu.
#include "point_head2.cuh"

extern "C" int ufo_point_head2_fast(const float* img, const float* vol, const float* sim,
                                    const float* dd, const float* dir, const float* rgb,
                                    const float* mask, const float* w, float* token, float* rad,
                                    int cv, int nv, int p, void* stream);

namespace ufo {
namespace ph2 {

template <int CV>
int launch(UFO_PH2_ARGS, float* scratch, int nv, int p, bool fast, cudaStream_t s) {
  if (nv < 2) return (int)cudaErrorInvalidValue;
  if (nv > kMaxViews)
    return launch_stream<CV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, scratch, nv, p,
                             fast, s);
  if (fast)   // w: the fast kernel's pack (ph2f::Img)
    return ufo_point_head2_fast(img, vol, sim, dd, dir, rgb, mask, w, token, rad, CV, nv, p, s);
  switch (nv) {
    UFO_PH2_CASE(2)
    UFO_PH2_CASE(3)
    UFO_PH2_CASE(4)
    UFO_PH2_CASE(5)
    default:
      return launch_views<CV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, nv, p, s);
  }
}

}  // namespace ph2
}  // namespace ufo

// The packed weights' length at volume width cv (16 or 24), else -1.
extern "C" int ufo_point_head2_weight_count(int cv) {
  using namespace ufo::ph2;
  return cv == 24 ? Dims<24>::N_W : cv == 16 ? Dims<16>::N_W : -1;
}

// Floats of global scratch a launch at nv views and p points needs (0 up
// to 11 views; past them the streamed kernel's keys, values and logits).
extern "C" long long ufo_point_head2_scratch_floats(int cv, int nv, int p) {
  using namespace ufo::ph2;
  return stream_scratch_floats(cv == 16 ? Dims<16>::C : Dims<24>::C, nv, p);
}

// Returns a cudaError_t value (0 on success). cv (the volume width) must
// be 16 or 24 and nv at least 2 (past 11 the streamed kernel, with the
// floats ufo_point_head2_scratch_floats asks for in scratch); fast picks
// the bf16 kernels: up to kMaxViews w is the fast kernel's pack
// (ufo_point_head2_fast_pack_bytes), past them the N_W floats with bf16
// planes.
extern "C" int ufo_point_head2(const float* img, const float* vol,
                               const float* sim, const float* dd,
                               const float* dir, const float* rgb,
                               const float* mask, const float* w, float* token,
                               float* rad, float* scratch, int cv, int nv, int p, int fast,
                               void* stream) {
  using namespace ufo::ph2;
  if (p <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f = fast != 0;
  switch (cv) {
    case 24:
      return launch<24>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, scratch, nv, p, f, s);
    case 16:
      return launch<16>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, scratch, nv, p, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
