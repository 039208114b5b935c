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
// Those are the widths of the correlation volume's 24 features. The
// feature grid's 16 (--volume_type featuregrid with the depth guide and
// the similarity, which the JAX gate also sends here) give tokens of 72,
// heads of 9, mlp 144 -> 144 -> 72 and a radiance input of 75: the volume
// width is a template parameter (Dims<CV>), both widths are instantiated.
//
// What bounds it on the H100: arithmetic. A point costs ~2.6e5 multiply-
// adds (the four token rows through the 80x80 and 160x160 layers)
// against ~1 KB of input and output, about 500 FLOP per byte of device
// memory, far above the card's ridge. As FP32 FMAs on the CUDA cores
// (common.cuh's block_gemm) the layers ran at ~20 % of the cores' 67
// TFLOP/s: each k step of a thread issued 4 weight loads and 4 shared
// loads for 16 FMAs, and each weight read served only 64 rows.
//
// Design: the q/k/v/merge projections, mlp1 over [tokens | message] and
// mlp2 (98 % of the multiply-adds) run on the tensor cores in 3xTF32
// (tc_gemm.cuh), accurate to a few FP32 roundings. A block of 320 threads
// owns TP = 16 points, i.e. 16 * (NV + 1) token rows (48, 64, 80, 96 rows
// at NV 2..5, whole m16 tiles). All activations of those rows stay in
// shared memory for the whole layer chain (buffers X and K of rows x 84
// floats, Q|V of rows x 168; strides padded against bank conflicts), and
// the weight planes (hi/lo, pre-split on the host) stream through a
// two-slot cp.async ring, each byte from L2 once per block. Shared memory:
// rows x 1344 bytes + 21,504 for the ring = 86,016 / 107,520 / 129,024 /
// 150,528 bytes at NV 2 / 3 / 4 / 5, so at NV 2 and 3 (the main path) two
// blocks share an SM and overlap each other's syncs.
//
// More views (NV 6..11, DTU's evaluation set 1 has 11): what bounds the
// tile is shared memory and the warps. A block holds at most 144 token
// rows: 144 x 1344 + 21,504 = 215,040 bytes of the 232,448 a block may
// have (160 rows would need 236,544), and nine m16 row tiles for ten
// warps (tc::gemm gives each warp one row tile). So a block owns TP =
// min(16, 144 / (NV + 1)) points, rounded down to a multiple of 4 (the
// small MLPs' block_linear takes rows in fours): 16 at NV 6..8 (112, 128,
// 144 rows), 12 at NV 9, 10 and 11 (120, 132, 144 rows, padded with zero
// rows to 128, 144, 144). One block an SM from NV 6 on (172,032 bytes and
// up), so the syncs no longer overlap; the weights still come from L2
// once per block, now per 112 to 144 rows. The per-view loads, the
// radiance rows (TP x NV) and the softmax's NV logits per thread grow with
// NV, not the registers of the tensor-core layers. The launch keeps the
// count a template parameter (a runtime count measured 23 % slower in the
// ray head); the NV 6..8 and 9..11 instances are built in
// point_head_views.cu and point_head_views_9_11.cu, beside the NV 2..5
// ones in point_head.cu, so the three compile side by side.
//
// The block's inputs (point-major, so contiguous) come in by cp.async,
// all in flight at once, image and volume features straight into the
// token rows. The pre-similarity MLP, the radiance MLP, the LayerNorms,
// the attention and the softmax stay FP32 on the CUDA cores.
//
// What bounds it now (H100 at P = 65,536, NV 3, variants timed apart):
// ~0.5 of its ~1.35 ms is outside the tensor-core layers, in short
// latency-bound phases between block-wide syncs: the radiance and
// pre-similarity MLPs (~0.15 and ~0.12 ms; a few warps each, one k step
// after another through common.cuh's block_gemm), the softmax and the
// attention. Inside them the products take ~0.5 ms (~190 TFLOP/s of TF32
// issued by mma.sync) and the operand split and fragment loads most of
// the rest; the weight ring's depth and the tile shape change nothing.
// wgmma's rate and a tail without per-phase syncs are what is left.
//
// This file's kernel is the 3xTF32 one (kernel_precision 'highest' and
// 'high': the exact path and training) at NV 2..11. kernel_precision
// 'fast' (the JAX kernel's single bf16 pass) runs point_head_fast.cuh's
// kernel at NV 2..11: persistent blocks with the bf16 weights resident in
// shared memory, two point tiles a block on named barriers, every layer
// and both small MLPs on the tensor cores up to 5 views, the layers
// FMA-summed from 6 on (its header has the design, its bound and its
// times). Past 11 views both precisions run point_head_stream.cu, which
// streams the token rows through shared memory in two passes. Dims, the
// pack layout and the tile helpers here serve all three.
#pragma once

#include "common.cuh"
#include "tc_gemm.cuh"

namespace ufo {
namespace ph {

constexpr int CI = 32;     // image-feature channels
constexpr int SIN = 8;     // cosine groups
constexpr int SH = 32;     // pre-similarity hidden width
constexpr int SOUT = 16;   // pre-similarity output width
constexpr int PE = 8;      // NeRF PE of the depth distance
constexpr int NH = 8;      // heads
constexpr int R1 = 16, R2 = 8;
constexpr int TP_MAX = 16; // points per block where they fit
constexpr int kMaxRows = 144;  // token rows a block holds at most
constexpr int kMaxViews = 11;  // the largest NV compiled in; past it, point_head_stream.cu
constexpr int kPointThreads = 320;
constexpr int kStages = 2; // weight ring slots

// The widths and the packed-weight offsets at a volume width CV: 24 (the
// correlation volume: tokens of 80, heads of 10) or 16 (the feature grid:
// tokens of 72, heads of 9). Both are instantiated; the layers' k and n
// stay multiples of 8, as tc_gemm.cuh needs.
template <int CV_>
struct Dims {
  static constexpr int CV = CV_;                 // volume-feature channels
  static constexpr int C = CI + CV + SOUT + PE;  // token width
  static constexpr int DK = C / NH;              // head width
  static constexpr int C2 = 2 * C;
  static constexpr int CR = C + 3;               // radiance MLP input
  static constexpr int LD = tc::act_ld(C);       // 84 / 76
  static constexpr int LD2 = tc::act_ld(C2);     // 164 / 148, mlp1's output in Q|V
  // Offsets into the packed weight buffer; the Python wrapper packs in
  // this order, every matrix in (in, out) row-major orientation, the
  // tensor-core matrices as a TF32 hi plane followed by its lo plane.
  static constexpr int O_TOK = 0;
  static constexpr int O_WQ = O_TOK + C;
  static constexpr int O_WK = O_WQ + 2 * C * C;
  static constexpr int O_WV = O_WK + 2 * C * C;
  static constexpr int O_WM = O_WV + 2 * C * C;
  static constexpr int O_N1S = O_WM + 2 * C * C;
  static constexpr int O_N1B = O_N1S + C;
  static constexpr int O_W1 = O_N1B + C;
  static constexpr int O_W2 = O_W1 + 2 * C2 * C2;
  static constexpr int O_N2S = O_W2 + 2 * C2 * C;
  static constexpr int O_N2B = O_N2S + C;
  static constexpr int O_SW0 = O_N2B + C;
  static constexpr int O_SB0 = O_SW0 + SIN * SH;
  static constexpr int O_SW1 = O_SB0 + SH;
  static constexpr int O_SB1 = O_SW1 + SH * SH;
  static constexpr int O_SW2 = O_SB1 + SH;
  static constexpr int O_SB2 = O_SW2 + SH * SOUT;
  static constexpr int O_RW0 = O_SB2 + SOUT;
  static constexpr int O_RB0 = O_RW0 + CR * R1;
  static constexpr int O_RW1 = O_RB0 + R1;
  static constexpr int O_RB1 = O_RW1 + R1 * R2;
  static constexpr int O_RW2 = O_RB1 + R2;
  static constexpr int O_RB2 = O_RW2 + R2;
  static constexpr int N_W = O_RB2 + 1;
  static_assert(C % NH == 0 && C % 8 == 0 && CV % 4 == 0, "widths the kernel tiles");
  // cp.async reads the tensor-core planes in 16-byte pieces
  static_assert(O_WQ % 4 == 0 && O_WK % 4 == 0 && O_WV % 4 == 0 && O_WM % 4 == 0 &&
                    O_W1 % 4 == 0 && O_W2 % 4 == 0,
                "tensor-core weight planes must start 16-byte aligned");
};

constexpr float kPi = 3.14159265358979323846f;

// points a block owns at NV views: a multiple of 4, the rows block_linear
// takes at a time
template <int NV>
__host__ __device__ constexpr int tile_points() {
  return TP_MAX < kMaxRows / (NV + 1) ? TP_MAX : kMaxRows / (NV + 1) / 4 * 4;
}

// token rows of the block: its points' NV + 1 tokens, padded to whole m16
// tiles
template <int NV>
__host__ __device__ constexpr int tile_rows() {
  return (tile_points<NV>() * (NV + 1) + 15) / 16 * 16;
}

template <int CV, int NV>
constexpr size_t smem_bytes() {
  using D = Dims<CV>;
  return sizeof(float) *
         ((size_t)tile_rows<NV>() * (2 * D::LD + 2 * D::LD) + tc::ring_floats(kStages, D::C2));
}

template <int CV, int NV>
__global__ void __launch_bounds__(kPointThreads, NV <= 5 ? 2 : 1) point_head_kernel(
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
  using D = Dims<CV>;
  constexpr int C = D::C, DK = D::DK, C2 = D::C2, CR = D::CR, LD = D::LD, LD2 = D::LD2;
  constexpr int O_TOK = D::O_TOK, O_WQ = D::O_WQ, O_WK = D::O_WK, O_WV = D::O_WV,
                O_WM = D::O_WM, O_N1S = D::O_N1S, O_N1B = D::O_N1B, O_W1 = D::O_W1,
                O_W2 = D::O_W2, O_N2S = D::O_N2S, O_N2B = D::O_N2B, O_SW0 = D::O_SW0,
                O_SB0 = D::O_SB0, O_SW1 = D::O_SW1, O_SB1 = D::O_SB1, O_SW2 = D::O_SW2,
                O_SB2 = D::O_SB2, O_RW0 = D::O_RW0, O_RB0 = D::O_RB0, O_RW1 = D::O_RW1,
                O_RB1 = D::O_RB1, O_RW2 = D::O_RW2, O_RB2 = D::O_RB2;
  constexpr int TP = tile_points<NV>();
  constexpr int L = NV + 1;           // tokens per point
  constexpr int R = tile_rows<NV>();  // token rows of the block, TP * L of them real
  constexpr int RR = TP * NV;         // radiance rows of the block
  constexpr int MTILES = R / 16;      // m16 tiles
  // column tiles of a warp's run in the C- and 2C-wide layers: one pass
  constexpr int NT_C = tc::col_tiles(kPointThreads / 32, MTILES, C);
  constexpr int NT_C2 = tc::col_tiles(kPointThreads / 32, MTILES, C2);
  static_assert(MTILES <= kPointThreads / 32, "a row tile per warp");
  static_assert(R % 16 == 0, "token rows must fill m16 tiles");
  static_assert(TP % 4 == 0, "block_linear takes the points' rows in fours");
  static_assert(RR * CR <= 2 * R * LD, "radiance input must fit Q|V");
  static_assert(LD2 <= 2 * LD, "mlp1's output must fit Q|V");
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // R x LD  tokens, later the layer output
  float* Kb = X + R * LD;             // R x LD  keys, then message / mlp2 out
  float* Qb = Kb + R * LD;            // R x LD  queries -> attention output
  float* Vb = Qb + R * LD;            // R x LD  values; Qb|Vb hold mlp1's R x LD2
  float* ring = Vb + R * LD;          // weight slots
  const int p0 = blockIdx.x * TP;
  const int tid = threadIdx.x;

  // 1. the block's inputs into shared memory, all loads in flight at
  //    once: raw cosines (group 0), image and volume features straight
  //    into the token rows (group 1); depth distances to scratch in Kb.
  //    A ragged last block loads element by element and zero-fills.
  float* s_in = Vb;               // pre-similarity MLP scratch in Vb
  float* s_h1 = s_in + TP * SIN;
  float* s_h2 = s_h1 + TP * SH;
  float* s16 = s_h2 + TP * SH;
  float* dds = Kb;                // (NV, TP) depth distances
  const bool full = p0 + TP <= P;
  if (full) {
    for (int i = tid; i < TP * SIN / 4; i += blockDim.x)
      tc::cp_async16(s_in + 4 * i, sim + (size_t)p0 * SIN + 4 * i);
  } else {
    for (int i = tid; i < TP * SIN; i += blockDim.x) {
      const int gp = p0 + i / SIN;
      s_in[i] = gp < P ? sim[(size_t)gp * SIN + i % SIN] : 0.f;
    }
  }
  tc::cp_async_commit();
  if (full) {
    for (int i = tid; i < NV * TP * (CI / 4); i += blockDim.x) {
      const int v = i / (TP * (CI / 4)), p = (i / (CI / 4)) % TP, c4 = i % (CI / 4);
      tc::cp_async16(X + (p * L + 1 + v) * LD + 4 * c4,
                     img + ((size_t)v * P + p0 + p) * CI + 4 * c4);
    }
    for (int i = tid; i < NV * TP * (CV / 4); i += blockDim.x) {
      const int v = i / (TP * (CV / 4)), p = (i / (CV / 4)) % TP, c4 = i % (CV / 4);
      tc::cp_async16(X + (p * L + 1 + v) * LD + CI + 4 * c4,
                     vol + (size_t)(p0 + p) * CV + 4 * c4);
    }
  } else {
    for (int i = tid; i < NV * TP * (CI + CV); i += blockDim.x) {
      const int v = i / (TP * (CI + CV)), p = (i / (CI + CV)) % TP, c = i % (CI + CV);
      const int gp = p0 + p;
      float val = 0.f;
      if (gp < P)
        val = c < CI ? img[((size_t)v * P + gp) * CI + c] : vol[(size_t)gp * CV + c - CI];
      X[(p * L + 1 + v) * LD + c] = val;
    }
  }
  tc::cp_async_commit();
  for (int i = tid; i < NV * TP; i += blockDim.x) {
    const int gp = p0 + i % TP;
    dds[i] = gp < P ? dd[(size_t)(i / TP) * P + gp] : 0.f;
  }
  tc::cp_async_wait<1>();
  __syncthreads();

  // 2. pre-similarity MLP on the block's points
  block_linear<4>(s_in, SIN, SIN, W + O_SW0, W + O_SB0, s_h1, SH, TP, SH, true);
  __syncthreads();
  block_linear<4>(s_h1, SH, SH, W + O_SW1, W + O_SB1, s_h2, SH, TP, SH, true);
  __syncthreads();
  block_linear<4>(s_h2, SH, SH, W + O_SW2, W + O_SB2, s16, SOUT, TP, SOUT, false);
  __syncthreads();

  // 3. the rest of the tokens: row p*L is the view token, row p*L + 1 + v
  //    view v's [img | vol | sim16 | pe] (zero for points past P)
  for (int i = tid; i < TP * C; i += blockDim.x)
    X[(i / C) * L * LD + i % C] = __ldg(W + O_TOK + i % C);
  constexpr int CT = C - CI - CV;   // sim16 | pe
  for (int i = tid; i < NV * TP * CT; i += blockDim.x) {
    const int v = i / (TP * CT), p = (i / CT) % TP, c = i % CT;
    float val = 0.f;
    if (p0 + p < P) {
      if (c < SOUT) {
        val = s16[p * SOUT + c];
      } else {
        const int k = c - SOUT;
        const float f = ldexpf(kPi, k >> 1);
        const float ph = (k & 1) ? 0.5f * kPi : 0.f;
        // the product and the sum rounded apart, as the plain version's
        // x * f + ph (an FMA would round once)
        val = sinf(__fadd_rn(__fmul_rn(dds[v * TP + p], f), ph));
      }
    }
    X[(p * L + 1 + v) * LD + CI + CV + c] = val;
  }
  if constexpr (R > TP * L) {     // the padding rows: zero, finite all through
    for (int i = tid; i < (R - TP * L) * LD; i += blockDim.x) X[TP * L * LD + i] = 0.f;
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // 4. projections on the tensor cores (the scratch in Vb and Kb is dead
  //    now); each gemm ends in a block-wide sync
  tc::gemm<kStages, NT_C>(X, LD, C, nullptr, 0, 0, W + O_WQ, ring, Qb, LD, MTILES, C, false);
  tc::gemm<kStages, NT_C>(X, LD, C, nullptr, 0, 0, W + O_WK, ring, Kb, LD, MTILES, C, false);
  tc::gemm<kStages, NT_C>(X, LD, C, nullptr, 0, 0, W + O_WV, ring, Vb, LD, MTILES, C, false);
  for (int i = tid; i < R * C; i += blockDim.x) {
    const int j = (i / C) * LD + i % C;
    Qb[j] = phi(Qb[j]);
    Kb[j] = phi(Kb[j]);
  }
  __syncthreads();

  // 5. linear attention among each point's L tokens, per head; the thread
  //    that reads q of (row, head) overwrites it with the attention output
  for (int t = tid; t < TP * L * NH; t += blockDim.x) {
    const int r = t / NH, h = t - (t / NH) * NH;
    const int base = (r / L) * L;
    float q[DK], acc[DK];
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      q[d] = Qb[r * LD + h * DK + d];
      acc[d] = 0.f;
    }
    float den = 0.f;
    for (int s = 0; s < L; ++s) {
      const float* ks = Kb + (base + s) * LD + h * DK;
      const float* vs = Vb + (base + s) * LD + h * DK;
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d) sc = fmaf(q[d], ks[d], sc);
      den += sc;
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] = fmaf(sc, vs[d], acc[d]);
    }
    den += kAttnEps;
#pragma unroll
    for (int d = 0; d < DK; ++d) Qb[r * LD + h * DK + d] = acc[d] / den;
  }
  __syncthreads();

  // 6. merge + LayerNorm -> Kb
  tc::gemm<kStages, NT_C>(Qb, LD, C, nullptr, 0, 0, W + O_WM, ring,
                                 Kb, LD, MTILES, C, false);
  tc::layernorm<C>(Kb, LD, R, W + O_N1S, W + O_N1B);
  // 7. mlp1 over [tokens | message] -> Qb|Vb (R x LD2)
  tc::gemm<kStages, NT_C2>(X, LD, C, Kb, LD, C, W + O_W1, ring, Qb, LD2, MTILES, C2, true);
  // 8. mlp2 -> Kb, LayerNorm added into X (the residual)
  tc::gemm<kStages, NT_C>(Qb, LD2, C2, nullptr, 0, 0, W + O_W2, ring,
                                 Kb, LD, MTILES, C, false);
  tc::layernorm<C>(Kb, LD, R, W + O_N2S, W + O_N2B, X, LD);

  // 9. view-token output
  for (int i = tid; i < TP * C; i += blockDim.x) {
    const int p = i / C, c = i - (i / C) * C;
    if (p0 + p < P) token_out[(size_t)(p0 + p) * C + c] = X[p * L * LD + c];
  }

  // 10. radiance: weight MLP over [view token out | dir_rel], masked softmax
  float* z = Qb;                  // RR x CR
  float* h1 = Kb;                 // RR x R1
  float* h2 = h1 + RR * R1;       // RR x R2
  float* lg = h2 + RR * R2;       // RR
  for (int i = tid; i < RR * 3; i += blockDim.x) {
    const int rr = i / 3, p = rr / NV, v = rr - (rr / NV) * NV;
    const int gp = p0 + p;
    z[rr * CR + C + i % 3] = gp < P ? dir[((size_t)v * P + gp) * 3 + i % 3] : 0.f;
  }
  for (int i = tid; i < RR * C; i += blockDim.x) {
    const int rr = i / C, c = i - (i / C) * C;
    const int p = rr / NV, v = rr - (rr / NV) * NV;
    z[rr * CR + c] = X[(p * L + 1 + v) * LD + c];
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

template <int CV, int NV>
int launch_nv(const float* img, const float* vol, const float* sim, const float* dd,
              const float* dir, const float* rgb, const float* mask, const float* w,
              float* token, float* rad, int p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CV, NV>();
  static_assert(smem <= 232448, "more shared memory than an sm_90 block may have");
  cudaError_t e = cudaFuncSetAttribute(
      point_head_kernel<CV, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p + tile_points<NV>() - 1) / tile_points<NV>();
  point_head_kernel<CV, NV><<<grid, kPointThreads, smem, stream>>>(
      img, vol, sim, dd, dir, rgb, mask, w, token, rad, p);
  return (int)cudaGetLastError();
}

#define UFO_PH_ARGS                                                              \
  const float *img, const float *vol, const float *sim, const float *dd,        \
      const float *dir, const float *rgb, const float *mask, const float *w,    \
      float *token, float *rad
#define UFO_PH_CASE(NV)                                                                    \
  case NV:                                                                                 \
    return launch_nv<CV, NV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, p, s);

// The 3xTF32 kernel: NV 6..8 (point_head_views.cu), the others through
// launch_views_9_11
template <int CV>
int launch_views(UFO_PH_ARGS, int nv, int p, cudaStream_t s);
// NV 9..kMaxViews (point_head_views_9_11.cu; cudaErrorInvalidValue otherwise)
template <int CV>
int launch_views_9_11(UFO_PH_ARGS, int nv, int p, cudaStream_t s);
// The fast kernel (point_head_fast.cuh) at NV 2..kMaxViews: NV 2..5 in
// point_head_fast.cu, 6..11 in point_head_fast_views.cu. w: its weight
// pack (phf::Img<CV>::PACK bytes, 16-byte aligned).
template <int CV>
int launch_fast(UFO_PH_ARGS, int nv, int p, cudaStream_t s);
template <int CV>
int launch_fast_views(UFO_PH_ARGS, int nv, int p, cudaStream_t s);
// Any NV above kMaxViews, both precisions (point_head_stream.cu): scratch
// holds stream_scratch_floats(C, nv, p) floats of global memory.
template <int CV>
int launch_stream(UFO_PH_ARGS, float* scratch, int nv, int p, bool fast, cudaStream_t s);
long long stream_scratch_floats(int c, int nv, int p);

}  // namespace ph
}  // namespace ufo
