// Split-weight per-point view head for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel point_head2_fused (body _kernel) of the
// JAX package's ops/fused_point_head2.py, reached with point_head='v2'. It
// computes what point_head.cu computes (pre-similarity MLP, NeRF PE of the
// depth distance, one LoFTR layer over the view token and NV view tokens,
// masked radiance softmax) on the same point-major inputs and weights, but
// never builds a view's 80-channel token [img 32 | vol 24 | sim16 16 |
// pe 8] (72 channels with the feature grid's 16 volume features: the
// volume width is a template parameter, Dims<CV>, and both widths are
// instantiated, as in point_head.cu). Each consumer of a token is split by feature group against the
// raw inputs:
//   q/k/v_v = [img_v | pe_v] Wview + [vol | sim16] Wshared,
//   mlp1_v  = [img_v | pe_v] W1a_view + [vol | sim16] W1a_shared + msg_v W1b,
//   r0_v    = [img_v | pe_v | dir_v] R0_view + m2_v R0[:80] + [vol | sim16] R0_shared,
// with the view-shared products computed once per point rather than once
// per view, and the view token's own q/k/v and mlp1 rows (tok_qkv,
// w1a_tok) computed on the host. At 3 views that is ~203.3k FMAs per
// point against point_head.cu's ~264.7k.
//
// What bounds it on the H100: arithmetic, as point_head.cu: ~2.0e5
// multiply-adds per point against ~1 KB in and out. 98 % of them (the
// shared projection, the per-view q/k/v, merge, mlp1, mlp2 and radiance
// layer 0) are layer GEMMs; as FP32 FMAs on the CUDA cores (common.cuh's
// block_gemm, the first design) they ran at ~17 % of the cores' 67
// TFLOP/s.
//
// Design: point_head.cu's. The layer GEMMs run on the tensor cores in
// 3xTF32 (tc_gemm.cuh), the weight planes (hi/lo, pre-split on the host)
// streaming through a two-slot cp.async ring. A block of 320 threads owns
// TP = 16 points: the 16 token rows first, then the 16 * NV view rows in
// (point, view) order, whole m16 tiles. The shared projection [vol |
// sim16] x (q | k | v | mlp1 | r0) runs once over the 16 point rows in
// three column panels (q | k, v, mlp1 | r0; the panels keep the ring at
// 176 columns), q | k and v straight into the token rows of the q|k and v
// buffers, which hold nothing else until the attention; the view rows'
// q | k and v gemms start their sums from their point's part there (the
// C-init of tc::gemm) and apply phi in their epilogue. mlp1 runs over all
// rows at once through [img | pe] (zero in the token rows) and the
// message, so the token rows get msg W1b and the view rows the whole
// per-view sum; a pass adds w1a_tok or the shared part and takes the relu.
// Radiance layer 0 runs there too, over [img | pe | dir | 1 1 1 | 0 0] and
// m2 of each view row (k = 48 + 80: the 1s take the bias, rows of the
// weight planes, and two zero rows pad it to a multiple of 8), starting
// from the point's shared part. The LayerNorms are tc::layernorm. Shared
// memory: rows x 1200 bytes + 15,296 (shared input and products, token
// constants) + 23,552 for the ring = 96,448 / 115,648 / 134,848 / 154,048
// bytes at NV 2 / 3 / 4 / 5, so at NV 2 and 3 (the main path) two blocks
// share an SM.
//
// More views (NV 6..11, DTU's evaluation set 1 has 11): shared memory and
// the warps bound the tile, as in point_head.cuh. The rows are one m16
// tile of token rows and TP * NV view rows padded to whole tiles; at most
// 160 rows (10 tiles for the 10 warps; 160 x 1200 + 38,848 = 230,848 of
// the 232,448 bytes a block may have), so TP * NV <= 144: TP = min(16,
// 144 / NV) points, 16 at NV 6..9 (173,248 to 230,848 bytes), 14 and 13
// at NV 10 and 11 (140 and 143 view rows, padded to 144 with zero rows;
// the token tile's rows past TP are zero too). One block an SM from NV 6
// on. The NV 6..11 instances are built in point_head2_views.cu, beside
// point_head2.cu's NV 2..5. The inputs come in by 16-byte cp.async (img and vol
// straight into their rows; a ragged last block element by element). The
// pre-similarity MLP, the attention, the radiance tail 16 -> 8 -> 1 and
// the softmax stay FP32 on the CUDA cores, one row per thread.
//
// This is the 3xTF32 kernel ('highest' and 'high'). In 'fast' the split
// head runs point_head2_fast.cuh at NV 2..11 and point_head2_stream.cu
// past them. The pack's radiance bias takes three rows (one row and two
// zero rows here; its bf16 hi, mid and lo parts in the streamed kernel's
// 'fast'). The view token's own q/k/v and mlp1 rows stay FP32, as in JAX.
#pragma once

#include "common.cuh"
#include "tc_gemm.cuh"

namespace ufo {
namespace ph2 {

constexpr int CI = 32;       // image-feature channels
constexpr int SIN = 8;       // cosine groups
constexpr int SHID = 32;     // pre-similarity hidden width
constexpr int SOUT = 16;     // pre-similarity output width (sim16)
constexpr int PE = 8;        // NeRF PE width
constexpr int NH = 8;        // heads
constexpr int R1 = 16, R2 = 8;
constexpr int GV = CI + PE;            // per-view group [img | pe]
constexpr int XW = GV + 3;             // a view row's raw inputs [img | pe | dir]
constexpr int NB = 3;                  // bias rows (ops/fused_point_head2.py BIAS_ROWS)
// radiance layer 0's first operand: [img | pe | dir | 1 1 1 | 0...], the
// 1s taking the bias rows of the weights, padded to a multiple of 8
constexpr int XK = (XW + NB + 7) / 8 * 8;   // 48
constexpr int TP_MAX = 16;             // points per block where they fit
constexpr int kMaxViewRows = 144;      // view rows a block holds at most
constexpr int kMaxViews = 11;          // the largest NV instantiated
constexpr int RT = 16;                 // token rows: one m16 tile, TP of them real
constexpr int kThreads = 320;
constexpr int kStages = 2;             // weight ring slots
constexpr int kSmallRows = 1;          // rows per thread in the small CUDA-core MLPs
constexpr int LX = tc::act_ld(XK);     // 52: rows of X
constexpr int LZ = tc::act_ld(R1);     // 20: radiance layer 0's output
static_assert(XK <= LX, "a view row's radiance input must fit its row");

// The widths and the packed-weight offsets at a volume width CV: 24 (the
// correlation volume: tokens of 80, heads of 10) or 16 (the feature grid:
// tokens of 72, heads of 9). Both are instantiated.
template <int CV_>
struct Dims {
  static constexpr int CV = CV_;                 // volume-feature channels
  static constexpr int C = CI + CV + SOUT + PE;  // token width
  static constexpr int DK = C / NH;              // head width
  static constexpr int C2 = 2 * C;
  static constexpr int GS = CV + SOUT;           // view-shared group [vol | sim16]
  static constexpr int NSH = 3 * C + C2 + R1;    // shared projections: q | k | v | mlp1 | r0
  static constexpr int NTAIL = C2 + R1;          // the shared mlp1 | r0 columns
  static constexpr int LS = tc::act_ld(GS);      // 44 / 36: rows of S
  static constexpr int LQK = tc::act_ld(2 * C);  // 164 / 148: q | k, later mlp1's output
  static constexpr int LV = tc::act_ld(C);       // 84 / 76: v, later the message and m2
  static constexpr int LT = tc::act_ld(NTAIL);   // 180 / 164: the shared mlp1 | r0 parts
  // Offsets into the packed weight buffer (ops/fused_point_head2.py
  // layout2), every matrix in (in, out) row-major orientation; the
  // tensor-core matrices as a TF32 hi plane followed by its lo plane.
  static constexpr int O_TOK = 0;                      // view token (C)
  static constexpr int O_TQKV = O_TOK + C;             // view token @ wq | wk | wv (3 x C)
  static constexpr int O_W1T = O_TQKV + 3 * C;         // view token @ w1[:C] (C2)
  static constexpr int O_SH = O_W1T + C2;              // 2 planes of GS x NSH
  static constexpr int O_VQKV = O_SH + 2 * GS * NSH;   // 2 planes of GV x 3C
  static constexpr int O_WM = O_VQKV + 2 * GV * 3 * C; // 2 planes of C x C
  static constexpr int O_N1S = O_WM + 2 * C * C;
  static constexpr int O_N1B = O_N1S + C;
  static constexpr int O_VW1 = O_N1B + C;  // 2 planes of (GV + C) x C2: view rows, then w1[C:]
  static constexpr int O_W2 = O_VW1 + 2 * (GV + C) * C2;  // 2 planes of C2 x C
  static constexpr int O_N2S = O_W2 + 2 * C2 * C;
  static constexpr int O_N2B = O_N2S + C;
  static constexpr int O_SW0 = O_N2B + C;
  static constexpr int O_SB0 = O_SW0 + SIN * SHID;
  static constexpr int O_SW1 = O_SB0 + SHID;
  static constexpr int O_SB1 = O_SW1 + SHID * SHID;
  static constexpr int O_SW2 = O_SB1 + SHID;
  static constexpr int O_SB2 = O_SW2 + SHID * SOUT;
  static constexpr int O_VRAD = O_SB2 + SOUT;  // 2 planes of (XK + C) x R1: view, dir,
                                               // bias, zero rows, then r0[:C]
  static constexpr int O_RW1 = O_VRAD + 2 * (XK + C) * R1;
  static constexpr int O_RB1 = O_RW1 + R1 * R2;
  static constexpr int O_RW2 = O_RB1 + R2;
  static constexpr int O_RB2 = O_RW2 + R2;
  static constexpr int N_W = O_RB2 + 1;
  static_assert(C % NH == 0 && C % 8 == 0 && GS % 8 == 0 && CV % 4 == 0,
                "widths the kernel tiles");
  // cp.async reads the tensor-core planes, and their column panels, in
  // 16-byte pieces
  static_assert(O_SH % 4 == 0 && O_VQKV % 4 == 0 && O_WM % 4 == 0 && O_VW1 % 4 == 0 &&
                    O_W2 % 4 == 0 && O_VRAD % 4 == 0 && NSH % 4 == 0 && (3 * C) % 4 == 0,
                "tensor-core weight planes must start 16-byte aligned");
};

constexpr float kPi = 3.14159265358979323846f;

// points a block owns at NV views
template <int NV>
__host__ __device__ constexpr int tile_points() {
  return TP_MAX < kMaxViewRows / NV ? TP_MAX : kMaxViewRows / NV;
}

// view rows of the block: TP * NV, padded to whole m16 tiles
template <int NV>
__host__ __device__ constexpr int view_rows() {
  return (tile_points<NV>() * NV + 15) / 16 * 16;
}

// rows of the block: the token tile, then the view rows
template <int NV>
__host__ __device__ constexpr int tile_rows() {
  return RT + view_rows<NV>();
}

template <int CV, int NV>
constexpr size_t smem_bytes() {
  using D = Dims<CV>;
  return sizeof(float) * ((size_t)tile_rows<NV>() * (D::LQK + D::LV + LX) +
                          RT * (D::LS + D::LT) + 3 * D::C + tc::ring_floats(kStages, D::NTAIL));
}

template <int CV, int NV>
__global__ void __launch_bounds__(kThreads, NV <= 5 ? 2 : 1) point_head2_kernel(
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
  constexpr int C = D::C, DK = D::DK, C2 = D::C2, GS = D::GS, NSH = D::NSH,
                NTAIL = D::NTAIL, LS = D::LS, LQK = D::LQK, LV = D::LV, LT = D::LT;
  constexpr int O_TOK = D::O_TOK, O_TQKV = D::O_TQKV, O_W1T = D::O_W1T, O_SH = D::O_SH,
                O_VQKV = D::O_VQKV, O_WM = D::O_WM, O_N1S = D::O_N1S, O_N1B = D::O_N1B,
                O_VW1 = D::O_VW1, O_W2 = D::O_W2, O_N2S = D::O_N2S, O_N2B = D::O_N2B,
                O_SW0 = D::O_SW0, O_SB0 = D::O_SB0, O_SW1 = D::O_SW1, O_SB1 = D::O_SB1,
                O_SW2 = D::O_SW2, O_SB2 = D::O_SB2, O_VRAD = D::O_VRAD, O_RW1 = D::O_RW1,
                O_RB1 = D::O_RB1, O_RW2 = D::O_RW2, O_RB2 = D::O_RB2;
  constexpr int TP = tile_points<NV>();
  constexpr int L = NV + 1;           // tokens per point
  constexpr int R = tile_rows<NV>();  // rows of the block: RT token rows, then RVP
  constexpr int RV = TP * NV;         // view rows, row RT + p * NV + v
  constexpr int RVP = view_rows<NV>();  // RV padded to whole m16 tiles
  constexpr int VT = RVP / 16, AT = R / 16;   // m16 tiles of the view rows, of all rows
  constexpr int NW = kThreads / 32;
  // column tiles of a warp's run in each gemm: one pass over k
  constexpr int NT_SQK = tc::col_tiles(NW, 1, 2 * C);
  constexpr int NT_SV = tc::col_tiles(NW, 1, C);
  constexpr int NT_ST = tc::col_tiles(NW, 1, NTAIL);
  constexpr int NT_VQK = tc::col_tiles(NW, VT, 2 * C);
  constexpr int NT_VV = tc::col_tiles(NW, VT, C);
  constexpr int NT_C = tc::col_tiles(NW, AT, C);
  constexpr int NT_C2 = tc::col_tiles(NW, AT, C2);
  constexpr int NT_R = tc::col_tiles(NW, VT, R1);
  static_assert(AT <= NW, "a row tile per warp");
  static_assert(TP <= RT, "the token rows fit one tile");
  static_assert(TP % kSmallRows == 0, "block_linear takes the rows kSmallRows at a time");
  static_assert(RVP * (LZ + R2 + 1) <= R * LQK, "radiance scratch must fit q|k");
  static_assert(TP * (SIN + 2 * SHID) <= TP * LQK, "similarity scratch must fit q|k");
  extern __shared__ float4 smem4[];
  float* QK = reinterpret_cast<float*>(smem4);  // R x LQK q | k -> attention out; mlp1 out
  float* Vb = QK + R * LQK;           // R x LV   v -> message -> m2
  float* X = Vb + R * LV;             // R x LX   token rows 0, view rows [img|pe|dir|1|0]
  float* S = X + R * LX;              // RT x LS  [vol | sim16]
  float* T = S + RT * LS;             // RT x LT  shared mlp1 | r0 parts
  float* tok3 = T + RT * LT;          // phi(token q) | phi(token k) | token v
  float* ring = tok3 + 3 * C;         // weight slots
  const int p0 = blockIdx.x * TP;
  const int tid = threadIdx.x;

  // 1. the block's inputs, the copies all in flight at once: raw cosines
  //    to scratch in QK, volume features into S, image features into the
  //    view rows of X. A ragged last block loads element by element and
  //    zero-fills.
  float* s_in = QK;
  float* s_h1 = s_in + TP * SIN;
  float* s_h2 = s_h1 + TP * SHID;
  if (p0 + TP <= P) {
    for (int i = tid; i < TP * SIN / 4; i += blockDim.x)
      tc::cp_async16(s_in + 4 * i, sim + (size_t)p0 * SIN + 4 * i);
    for (int i = tid; i < TP * (CV / 4); i += blockDim.x) {
      const int p = i / (CV / 4), c4 = i % (CV / 4);
      tc::cp_async16(S + p * LS + 4 * c4, vol + (size_t)(p0 + p) * CV + 4 * c4);
    }
    for (int i = tid; i < NV * TP * (CI / 4); i += blockDim.x) {
      const int v = i / (TP * (CI / 4)), p = (i / (CI / 4)) % TP, c4 = i % (CI / 4);
      tc::cp_async16(X + (RT + p * NV + v) * LX + 4 * c4,
                     img + ((size_t)v * P + p0 + p) * CI + 4 * c4);
    }
  } else {
    for (int i = tid; i < TP * SIN; i += blockDim.x) {
      const int gp = p0 + i / SIN;
      s_in[i] = gp < P ? sim[(size_t)gp * SIN + i % SIN] : 0.f;
    }
    for (int i = tid; i < TP * CV; i += blockDim.x) {
      const int p = i / CV, c = i % CV, gp = p0 + p;
      S[p * LS + c] = gp < P ? vol[(size_t)gp * CV + c] : 0.f;
    }
    for (int i = tid; i < NV * TP * CI; i += blockDim.x) {
      const int v = i / (TP * CI), p = (i / CI) % TP, c = i % CI, gp = p0 + p;
      X[(RT + p * NV + v) * LX + c] = gp < P ? img[((size_t)v * P + gp) * CI + c] : 0.f;
    }
  }
  tc::cp_async_commit();
  // the token rows of X, the token's constants, and each view row's PE,
  // dir, one and pad columns; the padding rows of X and S zero
  for (int i = tid; i < RT * LX; i += blockDim.x) X[i] = 0.f;
  if constexpr (RVP > RV) {
    for (int i = tid; i < (RVP - RV) * LX; i += blockDim.x) X[(RT + RV) * LX + i] = 0.f;
  }
  if constexpr (RT > TP) {
    for (int i = tid; i < (RT - TP) * LS; i += blockDim.x) S[TP * LS + i] = 0.f;
  }
  for (int i = tid; i < 3 * C; i += blockDim.x) {
    const float t = __ldg(W + O_TQKV + i);
    tok3[i] = i < 2 * C ? phi(t) : t;
  }
  constexpr int XR = LX - CI;
  for (int i = tid; i < RV * XR; i += blockDim.x) {
    const int rr = i / XR, c = CI + i % XR;
    const int p = rr / NV, v = rr - (rr / NV) * NV, gp = p0 + p;
    float val = 0.f;
    if (gp < P) {
      const size_t pv = (size_t)v * P + gp;
      if (c < GV) {
        const int k = c - CI;
        const float f = ldexpf(kPi, k >> 1);
        const float ph = (k & 1) ? 0.5f * kPi : 0.f;
        // the product and the sum rounded apart, as the plain version's
        // x * f + ph (an FMA would round once)
        val = sinf(__fadd_rn(__fmul_rn(dd[pv], f), ph));
      } else if (c < XW) {
        val = dir[pv * 3 + (c - GV)];
      }
    }
    X[(RT + rr) * LX + c] = c >= XW && c < XW + NB ? 1.f : val;
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // 2. pre-similarity MLP into S[:, CV:]
  block_linear<kSmallRows>(s_in, SIN, SIN, W + O_SW0, W + O_SB0, s_h1, SHID, TP, SHID, true);
  __syncthreads();
  block_linear<kSmallRows>(s_h1, SHID, SHID, W + O_SW1, W + O_SB1, s_h2, SHID, TP, SHID,
                           true);
  __syncthreads();
  block_linear<kSmallRows>(s_h2, SHID, SHID, W + O_SW2, W + O_SB2, S + CV, LS, TP, SOUT,
                           false);
  __syncthreads();

  // 3. on the tensor cores: the view-shared projections once per point, in
  //    column panels of sh (q | k and v into the token rows, mlp1 | r0 into
  //    T), then the view rows' [img | pe] through q | k and v; each gemm
  //    ends in a block-wide sync
  tc::gemm<kStages, NT_SQK>(S, LS, GS, nullptr, 0, 0, W + O_SH, ring, QK, LQK, 1, 2 * C,
                            false, NSH);
  tc::gemm<kStages, NT_SV>(S, LS, GS, nullptr, 0, 0, W + O_SH + 2 * C, ring, Vb, LV, 1, C,
                           false, NSH);
  tc::gemm<kStages, NT_ST>(S, LS, GS, nullptr, 0, 0, W + O_SH + 3 * C, ring, T, LT, 1,
                           NTAIL, false, NSH);
  // each view row's sums start from its point's shared part (view row
  // p * NV + v from token row p); phi of q and k in the epilogue
  tc::gemm<kStages, NT_VQK>(X + RT * LX, LX, GV, nullptr, 0, 0, W + O_VQKV, ring,
                            QK + RT * LQK, LQK, VT, 2 * C, tc::kPhi, 3 * C, QK, LQK, NV);
  tc::gemm<kStages, NT_VV>(X + RT * LX, LX, GV, nullptr, 0, 0, W + O_VQKV + 2 * C, ring,
                           Vb + RT * LV, LV, VT, C, tc::kNone, 3 * C, Vb, LV, NV);

  // 4. linear attention among each point's L tokens, per head; token 0's
  //    q, k, v are the constants. The thread of (row, head) writes its
  //    output over that row's q (the token rows' q columns held the shared
  //    part, read by the gemm above)
  for (int t = tid; t < TP * L * NH; t += blockDim.x) {
    const int p = t / (L * NH);
    const int l = (t / NH) - p * L;
    const int h = t - (t / NH) * NH;
    const int row = l == 0 ? p : RT + p * NV + l - 1;
    const float* qs = l == 0 ? tok3 + h * DK : QK + row * LQK + h * DK;
    float q[DK], acc[DK];
#pragma unroll
    for (int d = 0; d < DK; ++d) {
      q[d] = qs[d];
      acc[d] = 0.f;
    }
    float den = 0.f;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      const int rs = RT + p * NV + s - 1;
      const float* ks = s == 0 ? tok3 + C + h * DK : QK + rs * LQK + C + h * DK;
      const float* vv = s == 0 ? tok3 + 2 * C + h * DK : Vb + rs * LV + h * DK;
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < DK; ++d)
        sc = fmaf(q[d], ks[d], sc);
      den += sc;
#pragma unroll
      for (int d = 0; d < DK; ++d) acc[d] = fmaf(sc, vv[d], acc[d]);
    }
    den += kAttnEps;
    float* out = QK + row * LQK + h * DK;
#pragma unroll
    for (int d = 0; d < DK; ++d) out[d] = acc[d] / den;
  }
  __syncthreads();

  // 5. merge + LayerNorm -> the message in Vb (v is dead)
  tc::gemm<kStages, NT_C>(QK, LQK, C, nullptr, 0, 0, W + O_WM, ring, Vb, LV, AT, C, false);
  tc::layernorm<C>(Vb, LV, R, W + O_N1S, W + O_N1B);

  // 6. mlp1 over [[img | pe] | message] -> QK: the token rows get msg W1b
  //    (their X rows are zero), the view rows the whole per-view sum; then
  //    + w1a_tok or the point's shared part, and the relu
  tc::gemm<kStages, NT_C2>(X, LX, GV, Vb, LV, C, W + O_VW1, ring, QK, LQK, AT, C2, false);
  constexpr int C2_4 = C2 / 4;
  for (int i = tid; i < R * C2_4; i += blockDim.x) {
    const int r = i / C2_4, j = 4 * (i - (i / C2_4) * C2_4);
    const float4 b = r < RT ? __ldg(reinterpret_cast<const float4*>(W + O_W1T + j))
                            : *reinterpret_cast<const float4*>(T + ((r - RT) / NV) * LT + j);
    float4* y = reinterpret_cast<float4*>(QK + r * LQK + j);
    const float4 x = *y;
    *y = make_float4(fmaxf(x.x + b.x, 0.f), fmaxf(x.y + b.y, 0.f), fmaxf(x.z + b.z, 0.f),
                     fmaxf(x.w + b.w, 0.f));
  }
  __syncthreads();

  // 7. mlp2 + LayerNorm -> m2 in Vb (the message is dead)
  tc::gemm<kStages, NT_C>(QK, LQK, C2, nullptr, 0, 0, W + O_W2, ring, Vb, LV, AT, C, false);
  tc::layernorm<C>(Vb, LV, R, W + O_N2S, W + O_N2B);

  // 8. view-token output: the token plus its m2
  for (int i = tid; i < TP * C; i += blockDim.x) {
    const int p = i / C, c = i - (i / C) * C;
    if (p0 + p < P) token_out[(size_t)(p0 + p) * C + c] = __ldg(W + O_TOK + c) + Vb[p * LV + c];
  }

  // 9. radiance: layer 0 on the tensor cores over [img | pe | dir | 1 | 0]
  //    and m2 of each view row, starting from the point's shared part,
  //    relu; then 16 -> 8 -> 1 and the masked softmax
  float* z = QK;                      // RVP x LZ (mlp1's output is dead)
  float* h2 = z + RVP * LZ;           // RV x R2
  float* lg = h2 + RV * R2;           // RV
  tc::gemm<kStages, NT_R>(X + RT * LX, LX, XK, Vb + RT * LV, LV, C, W + O_VRAD, ring, z, LZ,
                          VT, R1, tc::kRelu, 0, T + C2, LT, NV);
  block_linear<kSmallRows>(z, LZ, R1, W + O_RW1, W + O_RB1, h2, R2, RV, R2, true);
  __syncthreads();
  block_linear<kSmallRows>(h2, R2, R2, W + O_RW2, W + O_RB2, lg, 1, RV, 1, false);
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

template <int CV, int NV>
int launch_nv(const float* img, const float* vol, const float* sim, const float* dd,
              const float* dir, const float* rgb, const float* mask, const float* w,
              float* token, float* rad, int p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CV, NV>();
  static_assert(smem <= 232448, "more shared memory than an sm_90 block may have");
  cudaError_t e = cudaFuncSetAttribute(
      point_head2_kernel<CV, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p + tile_points<NV>() - 1) / tile_points<NV>();
  point_head2_kernel<CV, NV><<<grid, kThreads, smem, stream>>>(
      img, vol, sim, dd, dir, rgb, mask, w, token, rad, p);
  return (int)cudaGetLastError();
}

#define UFO_PH2_ARGS                                                             \
  const float *img, const float *vol, const float *sim, const float *dd,        \
      const float *dir, const float *rgb, const float *mask, const float *w,    \
      float *token, float *rad
#define UFO_PH2_CASE(NV) \
  case NV: return launch_nv<CV, NV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, p, s);

// NV 6..kMaxViews (point_head2_views.cu; cudaErrorInvalidValue otherwise)
template <int CV>
int launch_views(UFO_PH2_ARGS, int nv, int p, cudaStream_t s);
// Any NV above kMaxViews, both precisions (point_head2_stream.cu): scratch
// holds stream_scratch_floats(C, nv, p) floats of global memory.
template <int CV>
int launch_stream(UFO_PH2_ARGS, float* scratch, int nv, int p, bool fast, cudaStream_t s);
long long stream_scratch_floats(int c, int nv, int p);

}  // namespace ph2
}  // namespace ufo
