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
                              float* rad, float* scratch, int cv, int nv, int p, int fast,
                              void* stream);
extern "C" int ufo_point_head_weight_count(int cv);
extern "C" int ufo_point_head_fast_pack_bytes(int cv);
extern "C" long long ufo_point_head_scratch_floats(int cv, int nv, int p);
extern "C" int ufo_point_head2(const float* img, const float* vol,
                               const float* sim, const float* dd,
                               const float* dir, const float* rgb,
                               const float* mask, const float* w, float* token,
                               float* rad, float* scratch, int cv, int nv, int p, int fast,
                               void* stream);
extern "C" int ufo_point_head2_weight_count(int cv);
extern "C" long long ufo_point_head2_scratch_floats(int cv, int nv, int p);
extern "C" int ufo_ray_head(const float* y, const float* w, float* srdf,
                            int rn, int sn, int c, int fast, void* stream);
extern "C" int ufo_ray_head_weight_count(int c);
extern "C" int ufo_ray_head_tile_rows(int sn, int c, int neus, long long limit);
extern "C" long long ufo_ray_head_smem_bytes(int sn, int c, int neus, long long limit);
extern "C" int ufo_ray_head_neus(const float* y, const float* w,
                                 const float* z, const float* rad,
                                 const float* inv_s, float* srdf, float* weight,
                                 float* rgb, float* depth, float* opacity,
                                 int rn, int sn, int c, int fast, void* stream);
extern "C" int ufo_ray_head_fast(const float* y, const float* w, float* srdf, int rn, int sn,
                                 int c, void* stream);
extern "C" int ufo_ray_head_neus_fast(const float* y, const float* w, const float* z,
                                      const float* rad, const float* inv_s, float* srdf,
                                      float* weight, float* rgb, float* depth, float* opacity,
                                      int rn, int sn, int c, void* stream);
extern "C" int ufo_ray_head_fast_pack_bytes(int c);
extern "C" int ufo_grouped_cosine(const float* x, long long sv, long long sp,
                                  long long sc, float* out, int nv, int p,
                                  int c, int g, void* stream);
extern "C" int ufo_volume_fusion(const float* const* fw, long long sv,
                                 long long sp, long long sc, float* out,
                                 int nv, int p, void* stream);
extern "C" int ufo_volume_fusion_stages();
extern "C" int ufo_volume_fusion_features();
extern "C" int ufo_volume_fusion_max_views();
extern "C" int ufo_tiny_attention_fwd(const float* q, const float* k, const float* v,
                                      float* o, int b, int l, int s, int h, int d,
                                      int m, void* stream);
extern "C" int ufo_tiny_attention_bwd(const float* q, const float* k, const float* v,
                                      const float* g, float* dq, float* dk, float* dv,
                                      int b, int l, int s, int h, int d, int m,
                                      void* stream);
extern "C" int ufo_row_gather(const void* src, const void* idx, void* out,
                              long long n_blocks, int v, int p, void* stream);
extern "C" int ufo_row_gather_row_bytes();
extern "C" const char* ufo_error_string(int e);

namespace {

void check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " kernel launch failed: CUDA error ", err, " (",
              ufo_error_string(err), ")");
}

// fast: the bf16 kernels (kernel_precision 'fast'), else 3xTF32; scratch:
// the floats point_head_scratch_floats asks for (past 11 views)
void point_head(const at::Tensor& img, const at::Tensor& vol,
                const at::Tensor& sim, const at::Tensor& dd,
                const at::Tensor& dir, const at::Tensor& rgb,
                const at::Tensor& mask, const at::Tensor& w,
                at::Tensor& token, at::Tensor& rad, at::Tensor& scratch, bool fast) {
  const int cv = static_cast<int>(vol.size(1));
  const int nv = static_cast<int>(img.size(0));
  const int p = static_cast<int>(img.size(1));
  check(ufo_point_head(img.data_ptr<float>(), vol.data_ptr<float>(),
                       sim.data_ptr<float>(), dd.data_ptr<float>(),
                       dir.data_ptr<float>(), rgb.data_ptr<float>(),
                       mask.data_ptr<float>(), w.data_ptr<float>(),
                       token.data_ptr<float>(), rad.data_ptr<float>(),
                       scratch.data_ptr<float>(), cv, nv, p, fast,
                       at::cuda::getCurrentCUDAStream().stream()),
        "point_head");
}

void point_head2(const at::Tensor& img, const at::Tensor& vol,
                 const at::Tensor& sim, const at::Tensor& dd,
                 const at::Tensor& dir, const at::Tensor& rgb,
                 const at::Tensor& mask, const at::Tensor& w,
                 at::Tensor& token, at::Tensor& rad, at::Tensor& scratch, bool fast) {
  const int cv = static_cast<int>(vol.size(1));
  const int nv = static_cast<int>(img.size(0));
  const int p = static_cast<int>(img.size(1));
  check(ufo_point_head2(img.data_ptr<float>(), vol.data_ptr<float>(),
                        sim.data_ptr<float>(), dd.data_ptr<float>(),
                        dir.data_ptr<float>(), rgb.data_ptr<float>(),
                        mask.data_ptr<float>(), w.data_ptr<float>(),
                        token.data_ptr<float>(), rad.data_ptr<float>(),
                       scratch.data_ptr<float>(), cv, nv, p, fast,
                        at::cuda::getCurrentCUDAStream().stream()),
        "point_head2");
}

void ray_head(const at::Tensor& y, const at::Tensor& w, at::Tensor& srdf, bool fast) {
  check(ufo_ray_head(y.data_ptr<float>(), w.data_ptr<float>(),
                     srdf.data_ptr<float>(), static_cast<int>(y.size(0)),
                     static_cast<int>(y.size(1)), static_cast<int>(y.size(2)), fast,
                     at::cuda::getCurrentCUDAStream().stream()),
        "ray_head");
}

void ray_head_neus(const at::Tensor& y, const at::Tensor& w,
                   const at::Tensor& z, const at::Tensor& rad,
                   const at::Tensor& inv_s, at::Tensor& srdf,
                   at::Tensor& weight, at::Tensor& rgb, at::Tensor& depth,
                   at::Tensor& opacity, bool fast) {
  check(ufo_ray_head_neus(y.data_ptr<float>(), w.data_ptr<float>(),
                          z.data_ptr<float>(), rad.data_ptr<float>(),
                          inv_s.data_ptr<float>(), srdf.data_ptr<float>(),
                          weight.data_ptr<float>(), rgb.data_ptr<float>(),
                          depth.data_ptr<float>(), opacity.data_ptr<float>(),
                          static_cast<int>(y.size(0)),
                          static_cast<int>(y.size(1)),
                          static_cast<int>(y.size(2)), fast,
                          at::cuda::getCurrentCUDAStream().stream()),
        "ray_head_neus");
}

// the fast ray heads at C 88 and 72 (csrc/ray_head_fast.cuh): w is the
// fast_image pack
void ray_head_fast(const at::Tensor& y, const at::Tensor& w, at::Tensor& srdf) {
  check(ufo_ray_head_fast(y.data_ptr<float>(), w.data_ptr<float>(), srdf.data_ptr<float>(),
                          static_cast<int>(y.size(0)), static_cast<int>(y.size(1)),
                          static_cast<int>(y.size(2)),
                          at::cuda::getCurrentCUDAStream().stream()),
        "ray_head_fast");
}

void ray_head_neus_fast(const at::Tensor& y, const at::Tensor& w, const at::Tensor& z,
                        const at::Tensor& rad, const at::Tensor& inv_s, at::Tensor& srdf,
                        at::Tensor& weight, at::Tensor& rgb, at::Tensor& depth,
                        at::Tensor& opacity) {
  check(ufo_ray_head_neus_fast(y.data_ptr<float>(), w.data_ptr<float>(), z.data_ptr<float>(),
                               rad.data_ptr<float>(), inv_s.data_ptr<float>(),
                               srdf.data_ptr<float>(), weight.data_ptr<float>(),
                               rgb.data_ptr<float>(), depth.data_ptr<float>(),
                               opacity.data_ptr<float>(), static_cast<int>(y.size(0)),
                               static_cast<int>(y.size(1)), static_cast<int>(y.size(2)),
                               at::cuda::getCurrentCUDAStream().stream()),
        "ray_head_neus_fast");
}

// sampled (NV, P, (NV-1) C) with any strides -> out (P, G)
void grouped_cosine(const at::Tensor& sampled, at::Tensor& out) {
  const int nv = static_cast<int>(sampled.size(0));
  check(ufo_grouped_cosine(sampled.data_ptr<float>(), sampled.stride(0),
                           sampled.stride(1), sampled.stride(2),
                           out.data_ptr<float>(), nv,
                           static_cast<int>(sampled.size(1)),
                           static_cast<int>(sampled.size(2) / (nv - 1)),
                           static_cast<int>(out.size(1)),
                           at::cuda::getCurrentCUDAStream().stream()),
        "grouped_cosine");
}

// three (NV, P, 9) stage samples sharing their strides, NV >= 1 -> out
// (P, 24) on a 16-byte boundary
void volume_fusion(const at::Tensor& fw0, const at::Tensor& fw1,
                   const at::Tensor& fw2, at::Tensor& out) {
  const float* fw[3] = {fw0.data_ptr<float>(), fw1.data_ptr<float>(),
                        fw2.data_ptr<float>()};
  check(ufo_volume_fusion(fw, fw0.stride(0), fw0.stride(1), fw0.stride(2),
                          out.data_ptr<float>(), static_cast<int>(fw0.size(0)),
                          static_cast<int>(fw0.size(1)),
                          at::cuda::getCurrentCUDAStream().stream()),
        "volume_fusion");
}

// q (B, L, H, D), k (B, S, H, D), v (B, S, H, M), all contiguous and on
// 16-byte boundaries (TMA bulk copies) -> out (B, L, H, M)
void tiny_attention_fwd(const at::Tensor& q, const at::Tensor& k,
                        const at::Tensor& v, at::Tensor& out) {
  check(ufo_tiny_attention_fwd(
            q.data_ptr<float>(), k.data_ptr<float>(), v.data_ptr<float>(),
            out.data_ptr<float>(), static_cast<int>(q.size(0)),
            static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
            static_cast<int>(q.size(2)), static_cast<int>(q.size(3)),
            static_cast<int>(v.size(3)), at::cuda::getCurrentCUDAStream().stream()),
        "tiny_attention_fwd");
}

// the same q, k, v and g (B, L, H, M), the output's gradient, all on
// 16-byte boundaries too -> dq, dk, dv
void tiny_attention_bwd(const at::Tensor& q, const at::Tensor& k,
                        const at::Tensor& v, const at::Tensor& g, at::Tensor& dq,
                        at::Tensor& dk, at::Tensor& dv) {
  check(ufo_tiny_attention_bwd(
            q.data_ptr<float>(), k.data_ptr<float>(), v.data_ptr<float>(),
            g.data_ptr<float>(), dq.data_ptr<float>(), dk.data_ptr<float>(),
            dv.data_ptr<float>(), static_cast<int>(q.size(0)),
            static_cast<int>(q.size(1)), static_cast<int>(k.size(1)),
            static_cast<int>(q.size(2)), static_cast<int>(q.size(3)),
            static_cast<int>(v.size(3)), at::cuda::getCurrentCUDAStream().stream()),
        "tiny_attention_bwd");
}

// src (n_blocks * block_rows, 128) bf16, idx (n_blocks * block_rows,)
// int32, both contiguous -> out (n_blocks * block_rows, 128)
void row_gather(const at::Tensor& src, const at::Tensor& idx, at::Tensor& out,
                int64_t block_rows) {
  check(ufo_row_gather(src.data_ptr(), idx.data_ptr(), out.data_ptr(),
                       src.size(0) / block_rows, static_cast<int>(block_rows),
                       static_cast<int>(block_rows),
                       at::cuda::getCurrentCUDAStream().stream()),
        "row_gather");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("point_head", &point_head, "fused per-point view head (csrc/point_head.cu)");
  m.def("point_head_weight_count", &ufo_point_head_weight_count);
  m.def("point_head_fast_pack_bytes", &ufo_point_head_fast_pack_bytes);
  m.def("point_head_scratch_floats", &ufo_point_head_scratch_floats);
  m.def("point_head2", &point_head2,
        "split-weight per-point view head (csrc/point_head2.cu)");
  m.def("point_head2_weight_count", &ufo_point_head2_weight_count);
  m.def("point_head2_scratch_floats", &ufo_point_head2_scratch_floats);
  m.def("ray_head", &ray_head, "fused along-ray SRDF head (csrc/ray_head.cu)");
  m.def("ray_head_weight_count", &ufo_ray_head_weight_count);
  m.def("ray_head_tile_rows", &ufo_ray_head_tile_rows);
  m.def("ray_head_smem_bytes", &ufo_ray_head_smem_bytes);
  m.def("ray_head_neus", &ray_head_neus,
        "fused along-ray SRDF head with the NeuS epilogue (csrc/ray_head.cu)");
  m.def("ray_head_fast", &ray_head_fast,
        "fast along-ray SRDF head at C 88 and 72 (csrc/ray_head_fast.cuh)");
  m.def("ray_head_neus_fast", &ray_head_neus_fast,
        "the same with the NeuS epilogue (csrc/ray_head_fast.cuh)");
  m.def("ray_head_fast_pack_bytes", &ufo_ray_head_fast_pack_bytes);
  m.def("grouped_cosine", &grouped_cosine,
        "grouped pairwise cosine (csrc/grouped_cosine.cu)");
  m.def("volume_fusion", &volume_fusion,
        "cross-view volume fusion (csrc/volume_fusion.cu)");
  m.def("volume_fusion_stages", &ufo_volume_fusion_stages);
  m.def("volume_fusion_features", &ufo_volume_fusion_features);
  m.def("volume_fusion_max_views", &ufo_volume_fusion_max_views);
  m.def("tiny_attention_fwd", &tiny_attention_fwd,
        "tiny-sequence linear attention (csrc/tiny_attention.cu)");
  m.def("tiny_attention_bwd", &tiny_attention_bwd,
        "its backward: dq, dk, dv (csrc/tiny_attention.cu)");
  m.def("row_gather", &row_gather, "block-local row gather (csrc/row_gather.cu)");
  m.def("row_gather_row_bytes", &ufo_row_gather_row_bytes);
}
