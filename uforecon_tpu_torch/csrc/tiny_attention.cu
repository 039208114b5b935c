// Tiny-sequence elu+1 linear attention for Hopper (sm_90a), forward and
// backward: the C entry points, the forward, and the backward for rows read
// in float4 pieces. The kernels and their design are in tiny_attention.cuh;
// the backward's other instances in tiny_attention_bwd2.cu and
// tiny_attention_bwd1.cu.
#include "tiny_attention.cuh"

// Both return a cudaError_t value (0 on success): cudaErrorInvalidValue for
// L or S outside 1..8, D or M outside 1..16, or rows that do not fit in
// shared memory. Tensors are contiguous float32 starting on 16-byte
// boundaries (TMA bulk copies).
extern "C" int ufo_tiny_attention_fwd(const float* q, const float* k, const float* v,
                                      float* o, int b, int l, int s, int h, int d,
                                      int m, void* stream) {
  using namespace ufo::ta;
  const Dims t{b, l, s, h, d, m};
  if (!dims_ok(t)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const FwdPlan plan = fwd_plan(t);
  if (plan.tile == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // q/k and v/out rows read and written in float4, float2 or float pieces
  if (d % 4 == 0 && m % 4 == 0) return launch_fwd<4>(q, k, v, o, t, plan, st);
  if (d % 2 == 0 && m % 2 == 0) return launch_fwd<2>(q, k, v, o, t, plan, st);
  return launch_fwd<1>(q, k, v, o, t, plan, st);
}

extern "C" int ufo_tiny_attention_bwd(const float* q, const float* k, const float* v,
                                      const float* g, float* dq, float* dk, float* dv,
                                      int b, int l, int s, int h, int d, int m,
                                      void* stream) {
  using namespace ufo::ta;
  const Dims t{b, l, s, h, d, m};
  if (!dims_ok(t)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const BwdPlan plan = bwd_plan(t);
  if (plan.tile == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && m % 4 == 0)
    return launch_bwd_tokens<4>(q, k, v, g, dq, dk, dv, t, plan, st);
  if (d % 2 == 0 && m % 2 == 0)
    return launch_bwd_tokens<2>(q, k, v, g, dq, dk, dv, t, plan, st);
  return launch_bwd_tokens<1>(q, k, v, g, dq, dk, dv, t, plan, st);
}
