// Fused per-point view head for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel point_head_fused (body _kernel) of the
// JAX package's ops/fused_point_head.py. Per sample point:
//   * pre-similarity MLP 8 -> 32 -> 32 -> 16 on the grouped cosines;
//   * NeRF PE of each view's depth distance (4 freqs -> 8);
//   * one view token + NV view tokens of 80 channels
//     (img 32 | vol 24 | sim 16 | pe 8);
//   * one LoFTR layer over the NV + 1 tokens: elu+1 linear attention with
//     8 heads x 10, LayerNorm(eps 1e-6), mlp 160 -> 160 -> 80, residual;
//   * radiance MLP 83 -> 16 -> 8 -> 1 per view, softmax over views masked
//     at -1e9, rgb blend.
// Only the view-token output (80) and the radiance (3) leave the kernel.
//
// What bounds it on the H100: arithmetic. A point costs ~2.6e5 FP32 FMAs
// (the four token rows through 80x80 and 160x160 layers) against ~1 KB of
// input and output, about 500 FLOP per byte of device memory, far above
// the card's FP32 ridge. The math must stay exact FP32, so the tensor
// cores (TF32 at best) are not used.
//
// Design: a block of 320 threads owns 16 points, i.e. 16 * (NV + 1) token
// rows. All activations of those rows stay in shared memory for the whole
// layer chain (4 buffers of rows x 80 floats, 80 KB at NV = 3, two blocks
// per SM); weights (~67k floats, too many for shared memory) are read
// through the read-only cache, where every block of the grid hits the same
// 268 KB. Each thread computes 4 x 4 tiles of rows x output columns
// (block_gemm). Inputs are point-major, so a block's loads are contiguous.
#include "common.cuh"

namespace ufo {
namespace ph {

constexpr int C = 80;      // token width
constexpr int CI = 32;     // image-feature channels
constexpr int CV = 24;     // volume-feature channels
constexpr int SIN = 8;     // cosine groups
constexpr int SH = 32;     // pre-similarity hidden width
constexpr int SOUT = 16;   // pre-similarity output width
constexpr int NH = 8;      // heads
constexpr int DK = C / NH; // head width 10
constexpr int C2 = 2 * C;
constexpr int CR = C + 3;  // radiance MLP input
constexpr int R1 = 16, R2 = 8;
constexpr int TP = 16;     // points per block
// 320 threads: the 64 x 80 and 64 x 160 layers of a block split into
// exactly one and two rounds of 4 x 4 output tiles (block_gemm)
constexpr int kPointThreads = 320;

// Offsets into the packed weight buffer; the Python wrapper packs in this
// order, every matrix in (in, out) row-major orientation.
constexpr int O_TOK = 0;
constexpr int O_WQ = O_TOK + C;
constexpr int O_WK = O_WQ + C * C;
constexpr int O_WV = O_WK + C * C;
constexpr int O_WM = O_WV + C * C;
constexpr int O_N1S = O_WM + C * C;
constexpr int O_N1B = O_N1S + C;
constexpr int O_W1 = O_N1B + C;
constexpr int O_W2 = O_W1 + C2 * C2;
constexpr int O_N2S = O_W2 + C2 * C;
constexpr int O_N2B = O_N2S + C;
constexpr int O_SW0 = O_N2B + C;
constexpr int O_SB0 = O_SW0 + SIN * SH;
constexpr int O_SW1 = O_SB0 + SH;
constexpr int O_SB1 = O_SW1 + SH * SH;
constexpr int O_SW2 = O_SB1 + SH;
constexpr int O_SB2 = O_SW2 + SH * SOUT;
constexpr int O_RW0 = O_SB2 + SOUT;
constexpr int O_RB0 = O_RW0 + CR * R1;
constexpr int O_RW1 = O_RB0 + R1;
constexpr int O_RB1 = O_RW1 + R1 * R2;
constexpr int O_RW2 = O_RB1 + R2;
constexpr int O_RB2 = O_RW2 + R2;
constexpr int N_W = O_RB2 + 1;

constexpr float kPi = 3.14159265358979323846f;

template <int NV>
constexpr size_t smem_bytes() {
  return sizeof(float) * 4 * TP * (NV + 1) * C;
}

template <int NV>
__global__ void __launch_bounds__(kPointThreads) point_head_kernel(
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
  constexpr int R = TP * L;           // token rows of the block
  constexpr int RR = TP * NV;         // radiance rows of the block
  static_assert(RR * CR <= 2 * R * C, "radiance input must fit Q|V");
  extern __shared__ float smem[];
  float* X = smem;                    // R x C   tokens, later the layer output
  float* Kb = X + R * C;              // R x C   keys, then message / mlp2 out
  float* Qb = Kb + R * C;             // R x C   queries -> attention output
  float* Vb = Qb + R * C;             // R x C   values; Qb|Vb hold mlp1's R x 2C
  const int p0 = blockIdx.x * TP;
  const int tid = threadIdx.x;

  // 1. pre-similarity MLP on the block's points (scratch in Vb)
  float* s_in = Vb;
  float* s_h1 = s_in + TP * SIN;
  float* s_h2 = s_h1 + TP * SH;
  float* s16 = s_h2 + TP * SH;
  for (int i = tid; i < TP * SIN; i += blockDim.x) {
    const int gp = p0 + i / SIN;
    s_in[i] = gp < P ? sim[(size_t)gp * SIN + i % SIN] : 0.f;
  }
  __syncthreads();
  block_linear<4>(s_in, SIN, SIN, W + O_SW0, W + O_SB0, s_h1, SH, TP, SH, true);
  __syncthreads();
  block_linear<4>(s_h1, SH, SH, W + O_SW1, W + O_SB1, s_h2, SH, TP, SH, true);
  __syncthreads();
  block_linear<4>(s_h2, SH, SH, W + O_SW2, W + O_SB2, s16, SOUT, TP, SOUT, false);
  __syncthreads();

  // 2. tokens: row p*L is the view token, row p*L + 1 + v view v's features
  for (int i = tid; i < R * C; i += blockDim.x) {
    const int r = i / C, c = i - (i / C) * C;
    const int p = r / L, l = r - (r / L) * L;
    const int gp = p0 + p;
    float val;
    if (l == 0) {
      val = __ldg(W + O_TOK + c);
    } else if (gp >= P) {
      val = 0.f;
    } else {
      const int v = l - 1;
      if (c < CI) {
        val = img[((size_t)v * P + gp) * CI + c];
      } else if (c < CI + CV) {
        val = vol[(size_t)gp * CV + (c - CI)];
      } else if (c < CI + CV + SOUT) {
        val = s16[p * SOUT + (c - CI - CV)];
      } else {
        const int k = c - (CI + CV + SOUT);
        const float f = ldexpf(kPi, k >> 1);
        const float ph = (k & 1) ? 0.5f * kPi : 0.f;
        val = sinf(dd[(size_t)v * P + gp] * f + ph);
      }
    }
    X[i] = val;
  }
  __syncthreads();

  // 3. projections (Vb's similarity scratch is dead now)
  block_linear<4>(X, C, C, W + O_WQ, nullptr, Qb, C, R, C, false);
  block_linear<4>(X, C, C, W + O_WK, nullptr, Kb, C, R, C, false);
  block_linear<4>(X, C, C, W + O_WV, nullptr, Vb, C, R, C, false);
  __syncthreads();
  for (int i = tid; i < R * C; i += blockDim.x) {
    Qb[i] = phi(Qb[i]);
    Kb[i] = phi(Kb[i]);
  }
  __syncthreads();

  // 4. linear attention among each point's L tokens, per head; the thread
  //    that reads q of (row, head) overwrites it with the attention output
  for (int t = tid; t < R * NH; t += blockDim.x) {
    const int r = t / NH, h = t - (t / NH) * NH;
    const int base = (r / L) * L;
    float q[DK], acc[DK];
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      q[d] = Qb[r * C + h * DK + d];
      acc[d] = 0.f;
    }
    float den = 0.f;
    for (int s = 0; s < L; ++s) {
      const float* ks = Kb + (base + s) * C + h * DK;
      const float* vs = Vb + (base + s) * C + h * DK;
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) sc = fmaf(q[d], ks[d], sc);
      den += sc;
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] = fmaf(sc, vs[d], acc[d]);
    }
    den += kAttnEps;
#pragma unroll
    for (int d = 0; d < DK; ++d) Qb[r * C + h * DK + d] = acc[d] / den;
  }
  __syncthreads();

  // 5. merge + LayerNorm -> Kb
  block_linear<4>(Qb, C, C, W + O_WM, nullptr, Kb, C, R, C, false);
  __syncthreads();
  block_layernorm(Kb, C, R, C, W + O_N1S, W + O_N1B);
  __syncthreads();
  // 6. mlp1 over [tokens | message] -> Qb|Vb (R x 2C)
  block_gemm<4>(X, C, C, Kb, C, C, W + O_W1, nullptr, Qb, C2, R, C2, true);
  __syncthreads();
  // 7. mlp2 -> Kb, LayerNorm, residual into X
  block_linear<4>(Qb, C2, C2, W + O_W2, nullptr, Kb, C, R, C, false);
  __syncthreads();
  block_layernorm(Kb, C, R, C, W + O_N2S, W + O_N2B);
  __syncthreads();
  for (int i = tid; i < R * C; i += blockDim.x) X[i] += Kb[i];
  __syncthreads();

  // 8. view-token output
  for (int i = tid; i < TP * C; i += blockDim.x) {
    const int p = i / C, c = i - (i / C) * C;
    if (p0 + p < P) token_out[(size_t)(p0 + p) * C + c] = X[p * L * C + c];
  }

  // 9. radiance: weight MLP over [view token out | dir_rel], masked softmax
  float* z = Qb;                  // RR x CR
  float* h1 = Kb;                 // RR x R1
  float* h2 = h1 + RR * R1;       // RR x R2
  float* lg = h2 + RR * R2;       // RR
  for (int i = tid; i < RR * CR; i += blockDim.x) {
    const int rr = i / CR, c = i - (i / CR) * CR;
    const int p = rr / NV, v = rr - (rr / NV) * NV;
    const int gp = p0 + p;
    float val;
    if (c < C) val = X[(p * L + 1 + v) * C + c];
    else val = gp < P ? dir[((size_t)v * P + gp) * 3 + (c - C)] : 0.f;
    z[i] = val;
  }
  __syncthreads();
  block_linear<4>(z, CR, CR, W + O_RW0, W + O_RB0, h1, R1, RR, R1, true);
  __syncthreads();
  block_linear<4>(h1, R1, R1, W + O_RW1, W + O_RB1, h2, R2, RR, R2, true);
  __syncthreads();
  block_linear<4>(h2, R2, R2, W + O_RW2, W + O_RB2, lg, 1, RR, 1, false);
  __syncthreads();
  for (int p = tid; p < TP; p += blockDim.x) {
    const int gp = p0 + p;
    if (gp >= P) continue;
    float logit[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v)
      logit[v] = mask[(size_t)v * P + gp] == 0.f ? -1e9f : lg[p * NV + v];
    // every point has a finite maximum: a point masked in all views gets
    // uniform weights (the mean rgb), as the JAX softmax does
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
      point_head_kernel<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p + TP - 1) / TP;
  point_head_kernel<NV><<<grid, kPointThreads, smem, stream>>>(
      img, vol, sim, dd, dir, rgb, mask, w, token, rad, p);
  return (int)cudaGetLastError();
}

}  // namespace ph
}  // namespace ufo

extern "C" int ufo_point_head_weight_count() { return ufo::ph::N_W; }

// Returns a cudaError_t value (0 on success). nv must be 2..5.
extern "C" int ufo_point_head(const float* img, const float* vol,
                              const float* sim, const float* dd,
                              const float* dir, const float* rgb,
                              const float* mask, const float* w, float* token,
                              float* rad, int nv, int p, void* stream) {
  using namespace ufo::ph;
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

extern "C" const char* ufo_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
