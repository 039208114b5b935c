// Split-weight per-point view head for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel point_head2_fused (body _kernel) of the
// JAX package's ops/fused_point_head2.py, reached with point_head='v2'. It
// computes what point_head.cu computes (pre-similarity MLP, NeRF PE of the
// depth distance, one LoFTR layer over the view token and NV view tokens,
// masked radiance softmax) on the same point-major inputs and weights, but
// never builds a view's 80-channel token [img 32 | vol 24 | sim16 16 |
// pe 8]. Each consumer of a token is split by feature group against the
// raw inputs:
//   q/k/v_v = [img_v | pe_v] Wview + [vol | sim16] Wshared,
//   mlp1_v  = [img_v | pe_v] W1a_view + [vol | sim16] W1a_shared + msg_v W1b,
//   r0_v    = [img_v | pe_v | dir_v] R0_view + m2_v R0[:80] + [vol | sim16] R0_shared,
// with the view-shared products computed once per point rather than once
// per view, and the view token's own q/k/v and mlp1 rows (tok_qkv,
// w1a_tok) computed on the host. At 3 views that is ~203.3k FMAs per
// point against point_head.cu's ~264.7k.
//
// What bounds it on the H100: arithmetic, as point_head.cu: ~2.0e5 exact
// FP32 FMAs per point against ~1 KB in and out. The TPU kernel's head-sum
// and head-broadcast 0/1 matmuls were a lane trick of the TPU; here a
// thread sums each head's 10 channels directly.
//
// Design: point_head.cu's frame. A block of 320 threads owns 16 points;
// the raw view rows [img | pe | dir] (48 x 44 floats at 3 views), the
// view-shared projections of each point (q, k, v, mlp1 and radiance parts,
// 16 x 416 floats, ~27 KB) and the activations of the layer chain stay in
// shared memory (~103 KB at 3 views: two blocks per SM); weights (~69k
// floats) are read through the read-only cache; every layer is a block
// GEMM of 4 x 4 output tiles per thread (block_gemm in common.cuh). Rows
// of a block: the 16 token rows first, then the 16 * NV view rows in
// (point, view) order. Points past P are computed on zeros and not stored.
#include "common.cuh"

namespace ufo {
namespace ph2 {

constexpr int C = 80;        // token width
constexpr int CI = 32;       // image-feature channels
constexpr int CV = 24;       // volume-feature channels
constexpr int SIN = 8;       // cosine groups
constexpr int SHID = 32;     // pre-similarity hidden width
constexpr int SOUT = 16;     // pre-similarity output width (sim16)
constexpr int PE = 8;        // NeRF PE width
constexpr int NH = 8;        // heads
constexpr int DK = C / NH;   // head width 10
constexpr int C2 = 2 * C;
constexpr int R1 = 16, R2 = 8;
constexpr int GS = CV + SOUT;          // view-shared group [vol | sim16]
constexpr int GV = CI + PE;            // per-view group [img | pe]
constexpr int XW = GV + 3;             // a view row's raw inputs [img | pe | dir]
constexpr int XLD = 44;                // its row stride in shared memory
constexpr int NSH = 3 * C + C2 + R1;   // shared projections: q | k | v | mlp1 | r0
constexpr int TP = 16;                 // points per block
constexpr int kThreads = 320;
static_assert(CI + CV + SOUT + PE == C, "token groups must fill the token");

// Offsets into the packed weight buffer (ops/fused_point_head2.py
// layout2), every matrix in (in, out) row-major orientation.
constexpr int O_TOK = 0;                      // view token (C)
constexpr int O_TQKV = O_TOK + C;             // view token @ wq | wk | wv (3 x C)
constexpr int O_W1T = O_TQKV + 3 * C;         // view token @ w1[:C] (C2)
constexpr int O_SH = O_W1T + C2;              // GS x NSH
constexpr int O_VQKV = O_SH + GS * NSH;       // GV x 3C
constexpr int O_WM = O_VQKV + GV * 3 * C;
constexpr int O_N1S = O_WM + C * C;
constexpr int O_N1B = O_N1S + C;
constexpr int O_VW1 = O_N1B + C;              // (GV + C) x C2: view rows, then w1[C:]
constexpr int O_W2 = O_VW1 + (GV + C) * C2;
constexpr int O_N2S = O_W2 + C2 * C;
constexpr int O_N2B = O_N2S + C;
constexpr int O_SW0 = O_N2B + C;
constexpr int O_SB0 = O_SW0 + SIN * SHID;
constexpr int O_SW1 = O_SB0 + SHID;
constexpr int O_SB1 = O_SW1 + SHID * SHID;
constexpr int O_SW2 = O_SB1 + SHID;
constexpr int O_SB2 = O_SW2 + SHID * SOUT;
constexpr int O_VRAD = O_SB2 + SOUT;          // (XW + C) x R1: view, dir rows, r0[:C]
constexpr int O_RB0 = O_VRAD + (XW + C) * R1;
constexpr int O_RW1 = O_RB0 + R1;
constexpr int O_RB1 = O_RW1 + R1 * R2;
constexpr int O_RW2 = O_RB1 + R2;
constexpr int O_RB2 = O_RW2 + R2;
constexpr int N_W = O_RB2 + 1;

constexpr float kPi = 3.14159265358979323846f;

// floats of the work area: q|k|v of the view rows and the attention output
// of all rows; later the message, mlp1 and mlp2 outputs, then the radiance
// layers, reuse it
template <int NV>
__host__ __device__ constexpr int work_floats() {
  return TP * NV * 3 * C + TP * (NV + 1) * C;
}

template <int NV>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (3 * C + TP * NSH + TP * NV * XLD + TP * GS + work_floats<NV>());
}

template <int NV>
__global__ void __launch_bounds__(kThreads) point_head2_kernel(
    const float* __restrict__ img,    // (NV, P, CI)
    const float* __restrict__ vol,    // (P, CV)
    const float* __restrict__ sim,    // (P, SIN)
    const float* __restrict__ dd,     // (NV, P)
    const float* __restrict__ dir,    // (NV, P, 3)
    const float* __restrict__ rgb,    // (NV, P, 3)
    const float* __restrict__ mask,   // (NV, P)
    const float* __restrict__ W,      // packed weights, N_W floats
    float* __restrict__ token_out,    // (P, C)
    float* __restrict__ rad_out,      // (P, 3)
    int P) {
  constexpr int L = NV + 1;           // tokens per point
  constexpr int R = TP * L;           // rows of the block: TP token rows, then RV
  constexpr int RV = TP * NV;         // view rows, row p * NV + v
  static_assert(R * C2 <= RV * 3 * C, "mlp1 output must fit beside the message");
  static_assert(R * C + RV * (R1 + R2 + 1) <= work_floats<NV>(), "radiance scratch");
  static_assert(TP * (SIN + 2 * SHID) <= work_floats<NV>(), "similarity scratch");
  extern __shared__ float smem[];
  float* tok3 = smem;                 // phi(token q) | phi(token k) | token v
  float* shr = tok3 + 3 * C;          // TP x NSH view-shared projections
  float* xv = shr + TP * NSH;         // RV x XLD raw view rows [img | pe | dir]
  float* vs = xv + RV * XLD;          // TP x GS [vol | sim16]
  float* wk = vs + TP * GS;           // work area
  const int p0 = blockIdx.x * TP;
  const int tid = threadIdx.x;

  // 0. the token's constant q, k, v and the block's raw inputs
  for (int i = tid; i < 3 * C; i += blockDim.x) {
    const float t = __ldg(W + O_TQKV + i);
    tok3[i] = i < 2 * C ? phi(t) : t;
  }
  float* s_in = wk;
  float* s_h1 = s_in + TP * SIN;
  float* s_h2 = s_h1 + TP * SHID;
  for (int i = tid; i < TP * SIN; i += blockDim.x) {
    const int gp = p0 + i / SIN;
    s_in[i] = gp < P ? sim[(size_t)gp * SIN + i % SIN] : 0.f;
  }
  for (int i = tid; i < TP * CV; i += blockDim.x) {
    const int p = i / CV, c = i - (i / CV) * CV;
    const int gp = p0 + p;
    vs[p * GS + c] = gp < P ? vol[(size_t)gp * CV + c] : 0.f;
  }
  for (int i = tid; i < RV * XLD; i += blockDim.x) {
    const int rr = i / XLD, c = i - (i / XLD) * XLD;
    const int p = rr / NV, v = rr - (rr / NV) * NV;
    const int gp = p0 + p;
    float val = 0.f;
    if (gp < P) {
      const size_t pv = (size_t)v * P + gp;
      if (c < CI) {
        val = img[pv * CI + c];
      } else if (c < GV) {
        const int k = c - CI;
        const float f = ldexpf(kPi, k >> 1);
        const float ph = (k & 1) ? 0.5f * kPi : 0.f;
        val = sinf(dd[pv] * f + ph);
      } else if (c < XW) {
        val = dir[pv * 3 + (c - GV)];
      }
    }
    xv[i] = val;
  }
  __syncthreads();

  // 1. pre-similarity MLP into vs[:, CV:]
  block_linear<4>(s_in, SIN, SIN, W + O_SW0, W + O_SB0, s_h1, SHID, TP, SHID, true);
  __syncthreads();
  block_linear<4>(s_h1, SHID, SHID, W + O_SW1, W + O_SB1, s_h2, SHID, TP, SHID, true);
  __syncthreads();
  block_linear<4>(s_h2, SHID, SHID, W + O_SW2, W + O_SB2, vs + CV, GS, TP, SOUT, false);
  __syncthreads();

  // 2. view-shared projections once per point; per-view q | k | v
  float* qkv = wk;                    // RV x 3C (the similarity scratch is dead)
  block_linear<4>(vs, GS, GS, W + O_SH, nullptr, shr, NSH, TP, NSH, false);
  block_linear<4>(xv, XLD, GV, W + O_VQKV, nullptr, qkv, 3 * C, RV, 3 * C, false);
  __syncthreads();
  for (int i = tid; i < RV * 3 * C; i += blockDim.x) {
    const int rr = i / (3 * C), j = i - (i / (3 * C)) * (3 * C);
    const float x = qkv[i] + shr[(rr / NV) * NSH + j];
    qkv[i] = j < 2 * C ? phi(x) : x;
  }
  __syncthreads();

  // 3. linear attention among each point's L tokens, per head; token 0's
  //    q, k, v are the constants
  float* att = wk + RV * 3 * C;       // R x C
  for (int t = tid; t < TP * L * NH; t += blockDim.x) {
    const int p = t / (L * NH);
    const int l = (t / NH) - p * L;
    const int h = t - (t / NH) * NH;
    const float* qs = l == 0 ? tok3 + h * DK : qkv + (p * NV + l - 1) * 3 * C + h * DK;
    float q[DK], acc[DK];
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      q[d] = qs[d];
      acc[d] = 0.f;
    }
    float den = 0.f;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      const float* row = s == 0 ? tok3 : qkv + (p * NV + s - 1) * 3 * C;
      const float* ks = row + C + h * DK;
      const float* vv = row + 2 * C + h * DK;
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) sc = fmaf(q[d], ks[d], sc);
      den += sc;
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] = fmaf(sc, vv[d], acc[d]);
    }
    den += kAttnEps;
    float* out = att + (l == 0 ? p : TP + p * NV + l - 1) * C + h * DK;
#pragma unroll
    for (int d = 0; d < DK; ++d) out[d] = acc[d] / den;
  }
  __syncthreads();

  // 4. merge + LayerNorm -> msg
  float* msg = wk;                    // R x C (q|k|v are dead)
  block_linear<4>(att, C, C, W + O_WM, nullptr, msg, C, R, C, false);
  __syncthreads();
  block_layernorm(msg, C, R, C, W + O_N1S, W + O_N1B);
  __syncthreads();

  // 5. mlp1: token rows relu(w1a_tok + msg W1b); view rows
  //    [img | pe] W1a_view + msg W1b, then + the shared part and relu
  float* y = wk + R * C;              // R x C2 (the attention output is dead)
  const float* w1b = W + O_VW1 + GV * C2;
  block_linear<4>(msg, C, C, w1b, W + O_W1T, y, C2, TP, C2, true);
  block_gemm<4>(xv, XLD, GV, msg + TP * C, C, C, W + O_VW1, nullptr, y + TP * C2,
                C2, RV, C2, false);
  __syncthreads();
  for (int i = tid; i < RV * C2; i += blockDim.x) {
    const int rr = i / C2, j = i - (i / C2) * C2;
    float* yy = y + TP * C2 + i;
    *yy = fmaxf(*yy + shr[(rr / NV) * NSH + 3 * C + j], 0.f);
  }
  __syncthreads();

  // 6. mlp2 + LayerNorm -> m2
  float* m2 = wk;                     // R x C (the message is dead)
  block_linear<4>(y, C2, C2, W + O_W2, nullptr, m2, C, R, C, false);
  __syncthreads();
  block_layernorm(m2, C, R, C, W + O_N2S, W + O_N2B);
  __syncthreads();

  // 7. view-token output: the token plus its m2
  for (int i = tid; i < TP * C; i += blockDim.x) {
    const int p = i / C, c = i - (i / C) * C;
    if (p0 + p < P) token_out[(size_t)(p0 + p) * C + c] = __ldg(W + O_TOK + c) + m2[i];
  }

  // 8. radiance: layer 0 over [img | pe | dir] and m2 of each view row plus
  //    the shared part, then 16 -> 8 -> 1 and the masked softmax
  float* z = wk + R * C;              // RV x R1 (mlp1's output is dead)
  float* h2 = z + RV * R1;            // RV x R2
  float* lg = h2 + RV * R2;           // RV
  block_gemm<4>(xv, XLD, XW, m2 + TP * C, C, C, W + O_VRAD, W + O_RB0, z, R1, RV, R1,
                false);
  __syncthreads();
  for (int i = tid; i < RV * R1; i += blockDim.x) {
    const int rr = i / R1, j = i - (i / R1) * R1;
    z[i] = fmaxf(z[i] + shr[(rr / NV) * NSH + 3 * C + C2 + j], 0.f);
  }
  __syncthreads();
  block_linear<4>(z, R1, R1, W + O_RW1, W + O_RB1, h2, R2, RV, R2, true);
  __syncthreads();
  block_linear<4>(h2, R2, R2, W + O_RW2, W + O_RB2, lg, 1, RV, 1, false);
  __syncthreads();
  for (int p = tid; p < TP; p += blockDim.x) {
    const int gp = p0 + p;
    if (gp >= P) continue;
    float logit[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v)
      logit[v] = mask[(size_t)v * P + gp] == 0.f ? -1e9f : lg[p * NV + v];
    // a point masked in all views gets uniform weights (the mean rgb), as
    // the JAX softmax does
    float m = logit[0];
#pragma unroll
    for (int v = 1; v < NV; ++v) m = fmaxf(m, logit[v]);
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      logit[v] = expf(logit[v] - m);
      sum += logit[v];
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        acc = fmaf(rgb[((size_t)v * P + gp) * 3 + ch], logit[v] / sum, acc);
      rad_out[(size_t)gp * 3 + ch] = acc;
    }
  }
}

template <int NV>
int launch(const float* img, const float* vol, const float* sim,
           const float* dd, const float* dir, const float* rgb,
           const float* mask, const float* w, float* token, float* rad,
           int p, cudaStream_t stream) {
  const size_t smem = smem_bytes<NV>();
  cudaError_t e = cudaFuncSetAttribute(
      point_head2_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p + TP - 1) / TP;
  point_head2_kernel<NV><<<grid, kThreads, smem, stream>>>(
      img, vol, sim, dd, dir, rgb, mask, w, token, rad, p);
  return (int)cudaGetLastError();
}

}  // namespace ph2
}  // namespace ufo

extern "C" int ufo_point_head2_weight_count() { return ufo::ph2::N_W; }

// Returns a cudaError_t value (0 on success). nv must be 2..5.
extern "C" int ufo_point_head2(const float* img, const float* vol,
                               const float* sim, const float* dd,
                               const float* dir, const float* rgb,
                               const float* mask, const float* w, float* token,
                               float* rad, int nv, int p, void* stream) {
  using namespace ufo::ph2;
  if (p <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 2: return launch<2>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, p, s);
    case 3: return launch<3>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, p, s);
    case 4: return launch<4>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, p, s);
    case 5: return launch<5>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
