// PyTorch bindings of the port's CUDA kernels (the only source that
// includes PyTorch's headers). Each function launches on PyTorch's current
// stream, allocates nothing, and raises if the launch is refused; the
// Python wrappers check shapes, types and devices before calling.
#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>

extern "C" int ufo_point_head(const float* img, const float* vol,
                              const float* sim, const float* dd,
                              const float* dir, const float* rgb,
                              const float* mask, const float* w, float* token,
                              float* rad, int nv, int p, void* stream);
extern "C" int ufo_point_head_weight_count();
extern "C" int ufo_ray_head(const float* y, const float* w, float* srdf,
                            int rn, int sn, void* stream);
extern "C" int ufo_ray_head_weight_count();
extern "C" long long ufo_ray_head_smem_bytes(int sn);
extern "C" const char* ufo_error_string(int e);

namespace {

void check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " kernel launch failed: CUDA error ", err, " (",
              ufo_error_string(err), ")");
}

void point_head(const at::Tensor& img, const at::Tensor& vol,
                const at::Tensor& sim, const at::Tensor& dd,
                const at::Tensor& dir, const at::Tensor& rgb,
                const at::Tensor& mask, const at::Tensor& w,
                at::Tensor& token, at::Tensor& rad) {
  const int nv = static_cast<int>(img.size(0));
  const int p = static_cast<int>(img.size(1));
  check(ufo_point_head(img.data_ptr<float>(), vol.data_ptr<float>(),
                       sim.data_ptr<float>(), dd.data_ptr<float>(),
                       dir.data_ptr<float>(), rgb.data_ptr<float>(),
                       mask.data_ptr<float>(), w.data_ptr<float>(),
                       token.data_ptr<float>(), rad.data_ptr<float>(), nv, p,
                       at::cuda::getCurrentCUDAStream().stream()),
        "point_head");
}

void ray_head(const at::Tensor& y, const at::Tensor& w, at::Tensor& srdf) {
  check(ufo_ray_head(y.data_ptr<float>(), w.data_ptr<float>(),
                     srdf.data_ptr<float>(), static_cast<int>(y.size(0)),
                     static_cast<int>(y.size(1)),
                     at::cuda::getCurrentCUDAStream().stream()),
        "ray_head");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("point_head", &point_head, "fused per-point view head (csrc/point_head.cu)");
  m.def("point_head_weight_count", &ufo_point_head_weight_count);
  m.def("ray_head", &ray_head, "fused along-ray SRDF head (csrc/ray_head.cu)");
  m.def("ray_head_weight_count", &ufo_ray_head_weight_count);
  m.def("ray_head_smem_bytes", &ufo_ray_head_smem_bytes);
}
