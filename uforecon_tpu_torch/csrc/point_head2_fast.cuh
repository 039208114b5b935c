// Split-weight per-point view head for Hopper (sm_90a), kernel_precision
// 'fast'.
//
// Replaces the Pallas TPU kernel point_head2_fused (body _kernel) of the
// JAX package's ops/fused_point_head2.py in its 'fast' mode, reached with
// point_head='v2': the single bf16 pass at its kernel_dot sites
// (fused_point_head2.py:73-76: both operands rounded to bf16, the exact
// products summed in FP32), the attention's head sums and broadcasts
// rounded as JAX's products with 0/1 matrices round them (each score a sum
// of bf16-rounded q k products, entering the weighted sum bf16-rounded; the
// denominator bf16-rounded), LayerNorms and softmax in FP32. The function,
// the split algebra and the pack's matrices are point_head2.cuh's; this is
// its bf16 design at NV 2..11 (past 11 views point_head2_stream.cu takes
// both precisions).
//
// What bounds it on the H100: the bf16 tensor cores, ~2.0e5 multiply-adds
// a point at NV 3 against ~1 KB in and out (0.0316 ms at P = 65,536, the
// bound chip_smoke prints). The first bf16 design (point_head2.cuh's
// 3xTF32 structure with bf16 operands, 0.849 ms, 3.7 % of the bound)
// spent its time around the products: blocks of 16 points, each streaming
// ~267 KB of FP32 words (bf16 values and a zero plane) from the L2 through
// a two-slot cp.async ring with a block-wide sync at each k step, and the
// two small MLPs as FP32 FMAs a row a thread between block-wide syncs.
//
// Design (point_head_fast.cuh's, for fast kernel 1, adapted to the split):
//   * Persistent blocks of 512 threads, one an SM. Every bf16 matrix of
//     the split pack (the shared projection sh, the view rows' q | k | v,
//     merge, mlp1 over [img | pe | message], mlp2, radiance layer 0 over
//     [img | pe | dir | 1 1 1 | 0 0 | m2], and both small MLPs: 70,528
//     bf16 at tokens of 80) and the LayerNorms' and small MLPs' FP32
//     vectors (142,704 bytes in all; 121,824 at tokens of 72) arrive once
//     per block by TMA bulk copies completing on an mbarrier and stay in
//     shared memory, each matrix as its (out, in) rows kpad apart, so that
//     a B fragment is one conflict-free 32-bit load. The view token's
//     constants (the token, phi of its q and k, its v, its mlp1 row:
//     tok_qkv and w1a_tok, computed on the host) follow the image in the
//     pack and are read from global memory.
//   * Rows in (point, token) order: row p * L is point p's view token, rows
//     p * L + 1 + v its views. Up to 5 views two groups of 8 warps, each
//     owning its own tile of GR = 32 rows (10, 8, 6, 5 points at NV 2..5)
//     and syncing on its own named barrier, so that one group's
//     latency-bound phases (loads, attention, LayerNorm, softmax) overlap
//     the other's products; from 6 views on one group of 16 warps on 64
//     rows (9 to 5 points: fewer padding rows, as Tiling says).
//   * Activations, 87,808 bytes beside the weights for 64 rows: the
//     operands that only a product reads are stored as bf16 where a buffer
//     is free for them, the rest in FP32. A group holds q, k and v (GR
//     rows of C + 4 floats each: the attention takes FP32 q, k and v); q's
//     rows then hold the attention output (FP32, bf16-rounded: written in
//     place, a head at a time) and mlp1's output (bf16 rows of kpad(2C)),
//     k's the message (bf16 rows of kpad(C)), v's the merge and mlp2
//     outputs and m2 (FP32, for the LayerNorms and the token output). Then
//     the per-point shared mlp1 | r0 parts (TP rows of 2C + 20 floats), and
//     in bf16 the view rows' raw inputs X = [img | pe | dir | 1 1 1 | 0 0]
//     (GR rows of 56) and the points' [vol | sim16] S (16 rows of 56). At
//     NV 2 and tokens of 80 that is 44,832 bytes a group: the block takes
//     232,384 of the 232,448 bytes an sm_90 block may have.
//   * v2's algebra: [vol | sim16] through the shared projection once a
//     point (one m16 tile), its q | k | v parts into the point's token rows
//     of Q, K and V (which the attention never reads: the token's own q,
//     k and v are the host constants), its mlp1 | r0 parts into T; the view
//     rows' [img | pe] through q | k | v, their point's shared part added
//     and phi taken in the epilogue; mlp1 over [img | pe | message] for
//     every row (the token rows' X is zero), w1a_tok or the point's shared
//     part added in the epilogue; radiance layer 0 over [X | m2] of each
//     view row, the bias as three bf16 rows (hi, mid, lo) against X's 1s,
//     so that it adds in FP32 as JAX's does.
//   * Each product's shapes are compile-time (gemm): a group's warps split
//     its m16 tiles evenly and each takes every (kW / MT)-th n8 tile of its
//     m tile. The pre-similarity MLP (one warp, beside the other warps'
//     input loads and NeRF PE) and the radiance MLP (a warp per 16 rows:
//     layer 0 and the 16 -> 8 -> 1 tail) run inside their warps on the
//     tensor cores with only __syncwarp between layers. LayerNorm takes a
//     row on eight threads. Eleven group barriers a tile.
//
// Sums: every product on the bf16 mma.m16n8k16 at every view count. They
// hold chip_smoke's element rule against the fast plain version at NV
// 2..11 and both widths, and its per-ray rule on a v2 render
// (script/views_agreement.py --point_head v2, four draws of 256 rays) at
// 3 and 6 views. At 7 to 11 views that render misses the per-ray rule on
// most draws with these sums and with FP32 FMA sums, k in order
// (point_head_fast.cuh's kFma: 3 of 4 draws missed at 7, 8 and 11 views,
// the kernel 50-70 % slower), and the point head's plain version on the
// card misses 1 or 2 draws of 4 at 8 and 11: the products' sum order is
// not what moves it, so the tensor cores keep their sums there too.
#pragma once

#include "point_head2.cuh"
#include "point_head_fast.cuh"

namespace ufo {
namespace ph2f {

using phf::group_layernorm;
using phf::group_sync;
using phf::kpad;
using phf::phi_sel;
using phf::smem_addr;
using phf::warp_linear;
using ph2::CI;
using ph2::Dims;
using ph2::GV;
using ph2::kPi;
using ph2::NH;
using ph2::PE;
using ph2::R1;
using ph2::R2;
using ph2::SHID;
using ph2::SIN;
using ph2::SOUT;
using ph2::XK;
using ph2::XW;

constexpr int kThreads = 512;
constexpr int kRows = 64;        // rows a block holds, over its groups
constexpr int kPiece = 32768;    // bytes a bulk copy moves at most
constexpr int XS = kpad(XK);     // 56: the bf16 stride of X's and S's rows
constexpr int SR = 16;           // rows of S: one m16 tile of points

// The tiling at NV views. Up to 5 views two groups of 8 warps, each on its
// own tile of GR = 32 rows, so that one group's latency-bound phases
// overlap the other's products; from 6 views on one group of 16 warps on
// 64 rows, which pads fewer rows (at NV 11 two points fill 24 of 32 rows,
// five points 60 of 64).
template <int NV>
struct Tiling {
  static constexpr int kGroups = NV > 5 ? 1 : 2;
  static constexpr int kWarps = kThreads / 32 / kGroups;
  static constexpr int kGroupThreads = 32 * kWarps;
  static constexpr int GR = kRows / kGroups;
  static constexpr int MT = GR / 16;
  static constexpr int TP = GR / (NV + 1);   // points of a tile
  static constexpr int RW = TP * (NV + 1);   // rows in use
};

// The weight pack (fused_point_head2.fast_image2): the image a block copies
// into shared memory, the split pack's bf16 matrices, each as its (out, in)
// rows kpad(in) apart (the last radiance layer's one row padded to 8 with
// zero rows), offsets in bf16 elements, then FP32 the LayerNorms' scales
// and biases and the small MLPs' biases, offsets in floats from F32; after
// the image (BYTES) the view token's constants in FP32, offsets in floats.
template <int CV>
struct Img {
  using D = Dims<CV>;
  static constexpr int C = D::C, C2 = D::C2, GS = D::GS, NSH = D::NSH;
  static constexpr int KG = kpad(GS), KV = kpad(GV), KC = kpad(C), KW1 = kpad(GV + C),
                       KC2 = kpad(C2), KR = kpad(XK + C), KS0 = kpad(SIN), KS = kpad(SHID),
                       KR1 = kpad(R1), KR2 = kpad(R2);
  static constexpr int SH = 0;                     // [vol | sim16] -> q | k | v | w1a | r0
  static constexpr int VQKV = SH + NSH * KG;       // [img | pe] -> q | k | v
  static constexpr int WM = VQKV + 3 * C * KV;
  static constexpr int VW1 = WM + C * KC;          // [img | pe | message] -> mlp1
  static constexpr int W2 = VW1 + C2 * KW1;
  static constexpr int VRAD = W2 + C * KC2;        // [img | pe | dir | 1 1 1 | 0 0 | m2] -> r0
  static constexpr int SW0 = VRAD + R1 * KR;       // pre-similarity MLP
  static constexpr int SW1 = SW0 + SHID * KS0;
  static constexpr int SW2 = SW1 + SHID * KS;
  static constexpr int RW1 = SW2 + SOUT * KS;      // radiance tail
  static constexpr int RW2 = RW1 + R2 * KR1;
  static constexpr int NBF = RW2 + 8 * KR2;
  static constexpr int N1S = 0, N1B = C, N2S = 2 * C, N2B = 3 * C;
  static constexpr int SB0 = 4 * C, SB1 = SB0 + SHID, SB2 = SB1 + SHID;
  static constexpr int RB1 = SB2 + SOUT, RB2 = RB1 + R2;
  static constexpr int NF = RB2 + 4;               // floats, the last bias padded
  static constexpr int F32 = 2 * NBF;              // byte offset of the FP32 part
  static constexpr int BYTES = F32 + 4 * NF;       // what a block copies
  // after the image: the token, phi(token q) | phi(token k) | token v,
  // token @ w1[:C]
  static constexpr int TOK = 0, TQKV = C, W1T = 4 * C;
  static constexpr int PACK = BYTES + 4 * 6 * C;
  static_assert(NBF % 8 == 0 && NF % 4 == 0, "bulk copies move multiples of 16 bytes");
};

// floats of a group's activations: Q, K, V (GR x LD), T (TP x LT), then X
// (GR rows) and S (SR rows) in bf16
template <int CV, int NV>
constexpr int group_floats() {
  using D = Dims<CV>;
  using T = Tiling<NV>;
  return 3 * T::GR * D::LV + T::TP * D::LT + (T::GR + SR) * XS / 2;
}

template <int CV, int NV>
constexpr size_t smem_bytes() {
  return Img<CV>::BYTES + 16 + sizeof(float) * (size_t)Tiling<NV>::kGroups *
                                   group_floats<CV, NV>();
}

// With UFO_PH2F_PROBE defined (script/head_variants.py's ph2f_probe),
// thread 0 of block 0 adds each phase's cycles, barrier included, to
// ph2f_probe[i] and counts its tiles in ph2f_probe[15]
// (ufo_point_head2_fast_probe reads them).
#ifdef UFO_PH2F_PROBE
static __device__ unsigned long long ph2f_probe[16];
#define PH2F_MARK(i)                                      \
  if (blockIdx.x == 0 && threadIdx.x == 0) {              \
    const unsigned long long now = clock64();             \
    ph2f_probe[i] += now - probe_t0;                      \
    probe_t0 = now;                                       \
    if ((i) == 10) ++ph2f_probe[15];                      \
  }
#else
#define PH2F_MARK(i)
#endif

// Two consecutive elements k, k + 1 of row r of an operand as a bf16 pair:
// stored as bf16 (kBf16, one 32-bit load) or FP32 (rounded here).
template <bool kBf16>
__device__ __forceinline__ uint32_t a_pair(const void* a, int ld, int r, int k) {
  if constexpr (kBf16) {
    return *reinterpret_cast<const uint32_t*>(static_cast<const uint16_t*>(a) + r * ld + k);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(static_cast<const float*>(a) + r * ld + k);
    return bf16x2_rn(v.x, v.y);
  }
}

// out[r, c] = sum_k a[r, k] W[k, c] over MT m16 tiles of rows and N
// columns, a = [a1 (K1 columns, stride LDA1) | a2 (K2, LDA2)] in shared
// memory, each bf16 (B1, B2) or FP32; W as its (N, KP) bf16 rows in shared
// memory. The shapes are compile-time, so the k loop unrolls and its
// addresses fold. The kW warps split the m tiles evenly: warp gw takes m
// tile gw % MT and every (kW / MT)-th n8 tile from gw / MT, so that an A
// fragment serves all of a warp's n tiles and the n tiles of a narrow
// product (N 80: ten) spread over more warps. epi(row, col, v0, v1) takes
// columns col, col + 1.
template <int MT, int kW, int N, int KP, int K1, int LDA1, bool B1, int K2, int LDA2, bool B2,
          typename Epi>
__device__ __forceinline__ void gemm(const void* a1, const void* a2, const uint16_t* wt, int gw,
                                     Epi epi) {
  constexpr int NTILES = N / 8, K = K1 + K2;
  static_assert(kW % MT == 0, "the warps split the m tiles evenly");
  constexpr int kWN = kW / MT;   // warps on an m tile
  constexpr int NT = (NTILES + kWN - 1) / kWN;
  static_assert(K1 % 8 == 0 && K2 % 8 == 0 && N % 8 == 0, "whole 8-wide tiles");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = (gw % MT) * 16 + g, jw = gw / MT;
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const uint16_t* wg = wt + g * KP + 2 * t;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kc = kk + 8 * h;   // compile-time: which operand, or zeros
      if (kc < K1) {
        a[2 * h] = a_pair<B1>(a1, LDA1, r, kc + 2 * t);
        a[2 * h + 1] = a_pair<B1>(a1, LDA1, r + 8, kc + 2 * t);
      } else if (kc < K) {
        a[2 * h] = a_pair<B2>(a2, LDA2, r, kc - K1 + 2 * t);
        a[2 * h + 1] = a_pair<B2>(a2, LDA2, r + 8, kc - K1 + 2 * t);
      } else {
        a[2 * h] = a[2 * h + 1] = 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int j = jw + kWN * i;
      if (j < NTILES) {
        const uint16_t* wc = wg + j * 8 * KP + kk;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wc);
        // past K the activations are zero and the weights read are the
        // row's padding or the next row's (finite bf16 weights: the small
        // MLPs' matrices follow these)
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wc + 8);
        tc::mma_bf16(acc[i], a, b0, b1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int j = jw + kWN * i;
    if (j < NTILES) {
      epi(r, 8 * j + 2 * t, acc[i][0], acc[i][1]);
      epi(r + 8, 8 * j + 2 * t, acc[i][2], acc[i][3]);
    }
  }
}

// Waits until the weight image's bulk copies, which complete on bar, have
// landed.
__device__ __forceinline__ void wait_weights(unsigned long long* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(0u)
        : "memory");
  }
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return static_cast<uint16_t>(bf16x2_rn(x, 0.f) & 0xffffu);
}

template <int CV, int NV>
__global__ void __launch_bounds__(kThreads, 1) point_head2_fast_kernel(
    const float* __restrict__ img,    // (NV, P, CI)
    const float* __restrict__ vol,    // (P, CV)
    const float* __restrict__ sim,    // (P, SIN)
    const float* __restrict__ dd,     // (NV, P)
    const float* __restrict__ dir,    // (NV, P, 3)
    const float* __restrict__ rgb,    // (NV, P, 3)
    const float* __restrict__ mask,   // (NV, P)
    const uint16_t* __restrict__ wimg,  // the weight pack (Img<CV>)
    float* __restrict__ token_out,    // (P, C)
    float* __restrict__ rad_out,      // (P, 3)
    int P) {
  using D = Dims<CV>;
  using I = Img<CV>;
  using T = Tiling<NV>;
  constexpr int C = D::C, DK = D::DK, C2 = D::C2, GS = D::GS, NSH = D::NSH, LD = D::LV,
                LT = D::LT, KM = I::KC, KY = I::KC2;
  constexpr int L = NV + 1;
  constexpr int kGroups = T::kGroups, kW = T::kWarps, kGT = T::kGroupThreads, GR = T::GR,
                MT = T::MT, TP = T::TP, RW = T::RW;
  static_assert(TP >= 1 && TP <= SR, "a tile's points: one m16 tile of S");
  static_assert(GS <= XS && XK <= XS && KM <= 2 * LD && KY <= 2 * LD && C + 4 <= LD &&
                    2 * C + 16 <= LT,
                "the buffers hold what the kernel puts there");
  static_assert(SR * (SIN + 2 * SHID + SOUT) <= GR * LD &&
                    MT * 16 * (R1 + R2) + GR <= GR * LD,
                "the small MLPs' scratch fits K");
  extern __shared__ float4 smem4[];
  uint16_t* Ws = reinterpret_cast<uint16_t*>(smem4);
  const float* F = reinterpret_cast<const float*>(reinterpret_cast<char*>(smem4) + I::F32);
  // the view token's constants, in global memory after the image
  const float* tokc = reinterpret_cast<const float*>(reinterpret_cast<const char*>(wimg) +
                                                     I::BYTES);
  auto* bar = reinterpret_cast<unsigned long long*>(reinterpret_cast<char*>(smem4) + I::BYTES);
  const int grp = threadIdx.x / kGT;
  const int gt = threadIdx.x - grp * kGT;   // thread of the group
  const int gw = gt >> 5;
  float* Qb = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + I::BYTES + 16) +
              grp * group_floats<CV, NV>();   // q -> attention output
  float* Kb = Qb + GR * LD;                   // k; scratch of the small MLPs
  float* Vb = Kb + GR * LD;                   // v -> merge -> mlp2 -> m2
  float* Tb = Vb + GR * LD;                   // TP x LT: the points' shared mlp1 | r0
  uint16_t* Xb = reinterpret_cast<uint16_t*>(Tb + TP * LT);   // GR x XS
  uint16_t* Sb = Xb + GR * XS;                                // SR x XS
  uint16_t* Mb = reinterpret_cast<uint16_t*>(Kb);   // GR x KM: the message, bf16
  uint16_t* Yb = reinterpret_cast<uint16_t*>(Qb);   // GR x KY: mlp1's output, bf16

  // the weight image, once per block: thread 0 starts the bulk copies,
  // every thread waits for them before its first product
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)), "r"((uint32_t)I::BYTES)
                 : "memory");
    for (int off = 0; off < I::BYTES; off += kPiece) {
      const uint32_t bytes = I::BYTES - off < kPiece ? I::BYTES - off : kPiece;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(reinterpret_cast<char*>(Ws) + off)),
          "l"(reinterpret_cast<const char*>(wimg) + off), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
    }
  }
  bool weights_in = false;

  const int tiles = (P + TP - 1) / TP;
  for (int tile = blockIdx.x * kGroups + grp; tile < tiles; tile += gridDim.x * kGroups) {
#ifdef UFO_PH2F_PROBE
    unsigned long long probe_t0 = clock64();
#endif
    const int p0 = tile * TP;
    // 1. inputs. One warp: the raw cosines and the pre-similarity MLP, its
    //    16 outputs into S's columns CV.. (bf16). The others: image
    //    features into the view rows of X and volume features into S, both
    //    bf16; each view row's NeRF PE of its depth distance, dir_rel and
    //    the 1s that take the radiance bias rows; its rgb and mask into its
    //    V row's padding columns C..C+3 (which no product reads or
    //    writes); X's token and padding rows and S's padding rows zero
    if (gw == 0) {
      float* s_in = Kb;                 // SR x SIN
      float* s_h1 = s_in + SR * SIN;    // SR x SHID
      float* s_h2 = s_h1 + SR * SHID;   // SR x SHID
      float* s16 = s_h2 + SR * SHID;    // SR x SOUT
      for (int i = gt; i < SR * SIN; i += 32) {
        const int p = i / SIN, gp = p0 + p;
        s_in[i] = p < TP && gp < P ? __ldg(sim + (size_t)gp * SIN + i % SIN) : 0.f;
      }
      if (!weights_in) wait_weights(bar);
      __syncwarp();
      warp_linear(s_in, SIN, SIN, Ws + I::SW0, I::KS0, F + I::SB0, s_h1, SHID, SHID, true);
      __syncwarp();
      warp_linear(s_h1, SHID, SHID, Ws + I::SW1, I::KS, F + I::SB1, s_h2, SHID, SHID,
                         true);
      __syncwarp();
      warp_linear(s_h2, SHID, SHID, Ws + I::SW2, I::KS, F + I::SB2, s16, SOUT, SOUT,
                         false);
      __syncwarp();
      for (int i = gt; i < TP * SOUT; i += 32)
        Sb[(i / SOUT) * XS + CV + i % SOUT] = bf16_bits(s16[i]);
    } else {
      const int lt = gt - 32;             // thread of the loading warps
      constexpr int kLT = kGT - 32;
      for (int i = lt; i < NV * TP * (CI / 4); i += kLT) {
        const int v = i / (TP * (CI / 4)), p = (i / (CI / 4)) % TP, c4 = i % (CI / 4);
        const int gp = p0 + p;
        const float4 x = gp < P ? __ldg(reinterpret_cast<const float4*>(
                                            img + ((size_t)v * P + gp) * CI) + c4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<uint2*>(Xb + (p * L + 1 + v) * XS + 4 * c4) =
            make_uint2(bf16x2_rn(x.x, x.y), bf16x2_rn(x.z, x.w));
      }
      for (int i = lt; i < TP * (CV / 4); i += kLT) {
        const int p = i / (CV / 4), c4 = i % (CV / 4), gp = p0 + p;
        const float4 x = gp < P ? __ldg(reinterpret_cast<const float4*>(vol + (size_t)gp * CV) +
                                        c4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<uint2*>(Sb + p * XS + 4 * c4) =
            make_uint2(bf16x2_rn(x.x, x.y), bf16x2_rn(x.z, x.w));
      }
      for (int i = lt; i < NV * TP; i += kLT) {
        const int v = i / TP, p = i % TP, gp = p0 + p;
        const bool in = gp < P;
        const size_t pv = (size_t)v * P + gp;
        float* vr = Vb + (p * L + 1 + v) * LD + C;
        vr[0] = in ? __ldg(rgb + pv * 3) : 0.f;
        vr[1] = in ? __ldg(rgb + pv * 3 + 1) : 0.f;
        vr[2] = in ? __ldg(rgb + pv * 3 + 2) : 0.f;
        vr[3] = in ? __ldg(mask + pv) : 0.f;
      }
      constexpr int XR = XK - CI;   // X's columns after the image features
      for (int i = lt; i < NV * TP * XR; i += kLT) {
        const int v = i / (TP * XR), p = (i / XR) % TP, c = CI + i % XR, gp = p0 + p;
        float val = 0.f;
        if (gp < P) {
          const size_t pv = (size_t)v * P + gp;
          if (c < GV) {
            const int k = c - CI;
            const float f = ldexpf(kPi, k >> 1);
            const float ph = (k & 1) ? 0.5f * kPi : 0.f;
            // the product and the sum rounded apart, as the plain version's
            // x * f + ph (an FMA would round once)
            val = sinf(__fadd_rn(__fmul_rn(__ldg(dd + pv), f), ph));
          } else if (c < XW) {
            val = __ldg(dir + pv * 3 + (c - GV));
          }
        }
        Xb[(p * L + 1 + v) * XS + c] = bf16_bits(c >= XW && c < XW + ph2::NB ? 1.f : val);
      }
      uint32_t* x32 = reinterpret_cast<uint32_t*>(Xb);
      for (int i = lt; i < GR * (XS / 2); i += kLT) {
        const int r = i / (XS / 2);
        if (r % L == 0 || r >= RW) x32[i] = 0u;
      }
      for (int i = lt; i < (SR - TP) * (XS / 2); i += kLT)
        reinterpret_cast<uint32_t*>(Sb + TP * XS)[i] = 0u;
      if (!weights_in) wait_weights(bar);
    }
    weights_in = true;
    group_sync<kGT>(grp);
    PH2F_MARK(0);

    // 2. the shared projection of [vol | sim16], once a point: its q | k |
    //    v parts into the point's token rows of Q, K and V, its mlp1 | r0
    //    parts into T
    gemm<1, kW, NSH, I::KG, GS, XS, true, 0, XS, true>(
        Sb, nullptr, Ws + I::SH, gw, [&](int r, int c, float v0, float v1) {
          if (r >= TP) return;
          float* dst = c < 3 * C ? Qb + (c / C) * GR * LD + r * L * LD + c % C
                                 : Tb + r * LT + c - 3 * C;
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        });
    group_sync<kGT>(grp);
    PH2F_MARK(1);

    // 3. the view rows' [img | pe] through q | k | v, their point's shared
    //    part added and phi of q and k taken in the epilogue (the token
    //    rows keep the shared parts: the attention reads the token's own
    //    q, k and v from its constants)
    gemm<MT, kW, 3 * C, I::KV, GV, XS, true, 0, XS, true>(
        Xb, nullptr, Ws + I::VQKV, gw, [&](int r, int c, float v0, float v1) {
          if (r >= RW || r % L == 0) return;
          const int which = c / C, cc = c % C;
          float* buf = Qb + which * GR * LD;
          const float2 s = *reinterpret_cast<const float2*>(buf + (r / L) * L * LD + cc);
          v0 += s.x;
          v1 += s.y;
          if (which < 2) { v0 = phi_sel(v0); v1 = phi_sel(v1); }
          *reinterpret_cast<float2*>(buf + r * LD + cc) = make_float2(v0, v1);
        });
    group_sync<kGT>(grp);
    PH2F_MARK(2);

    // 4. linear attention among each point's L tokens, per head, token 0's
    //    q, k and v the constants; the thread of (row, head) overwrites its
    //    q with the output, rounded to bf16 (merge's operand only)
    for (int it = gt; it < RW * NH; it += kGT) {
      const int r = it / NH, h = it - (it / NH) * NH;
      const int base = (r / L) * L;
      float q[DK], acc[DK];
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        q[d] = r == base ? __ldg(tokc + I::TQKV + h * DK + d) : Qb[r * LD + h * DK + d];
        acc[d] = 0.f;
      }
      float den = 0.f;
#pragma unroll
      for (int s = 0; s < L; ++s) {
        const float* ks = s == 0 ? tokc + I::TQKV + C + h * DK : Kb + (base + s) * LD + h * DK;
        const float* vs = s == 0 ? tokc + I::TQKV + 2 * C + h * DK : Vb + (base + s) * LD + h * DK;
        float sc = 0.f;
#pragma unroll
        for (int d = 0; d < DK; ++d) sc += bf16_round(q[d] * ks[d]);
        den += sc;
        const float w = bf16_round(sc);
#pragma unroll
        for (int d = 0; d < DK; ++d) acc[d] = fmaf(w, vs[d], acc[d]);
      }
      den = bf16_round(den) + kAttnEps;
#pragma unroll
      for (int d = 0; d < DK; ++d) Qb[r * LD + h * DK + d] = bf16_round(acc[d] / den);
    }
    group_sync<kGT>(grp);
    PH2F_MARK(3);

    // 5. merge -> V (v is dead; its padding columns keep rgb and mask),
    //    then LayerNorm, the message into K as bf16 (k is dead; mlp1's
    //    operand only)
    gemm<MT, kW, C, I::KC, C, LD, false, 0, LD, false>(
        Qb, nullptr, Ws + I::WM, gw, [&](int r, int c, float v0, float v1) {
          *reinterpret_cast<float2*>(Vb + r * LD + c) = make_float2(v0, v1);
        });
    group_sync<kGT>(grp);
    PH2F_MARK(4);
    group_layernorm<C, kGT>(Vb, LD, GR, gt, F + I::N1S, F + I::N1B,
                          [&](int r, int c, float y) { Mb[r * KM + c] = bf16_bits(y); });
    group_sync<kGT>(grp);
    PH2F_MARK(5);

    // 6. mlp1 over [[img | pe] | message] -> Y, bf16 in Q (the attention
    //    output is dead; mlp2's operand only): the token rows get msg W1b
    //    (their X rows are zero) and w1a_tok, the view rows the whole
    //    per-view sum and their point's shared part; relu
    gemm<MT, kW, C2, I::KW1, GV, XS, true, C, KM, true>(
        Xb, Mb, Ws + I::VW1, gw, [&](int r, int c, float v0, float v1) {
          if (r >= RW) return;
          const float2 b = r % L == 0
                               ? make_float2(__ldg(tokc + I::W1T + c), __ldg(tokc + I::W1T + c + 1))
                               : *reinterpret_cast<const float2*>(Tb + (r / L) * LT + c);
          *reinterpret_cast<uint32_t*>(Yb + r * KY + c) =
              bf16x2_rn(fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
        });
    group_sync<kGT>(grp);
    PH2F_MARK(6);
    // 7. mlp2 -> V (the message is dead), then LayerNorm in place: m2, FP32
    gemm<MT, kW, C, I::KC2, C2, KY, true, 0, KY, true>(
        Yb, nullptr, Ws + I::W2, gw, [&](int r, int c, float v0, float v1) {
          *reinterpret_cast<float2*>(Vb + r * LD + c) = make_float2(v0, v1);
        });
    group_sync<kGT>(grp);
    PH2F_MARK(7);
    group_layernorm<C, kGT>(Vb, LD, GR, gt, F + I::N2S, F + I::N2B,
                          [&](int r, int c, float y) { Vb[r * LD + c] = y; });
    group_sync<kGT>(grp);
    PH2F_MARK(8);

    // 8. the view-token output, the token plus its m2; the radiance MLP
    //    over each row's [X | m2], a warp per 16 rows, its point's shared
    //    r0 part added in layer 0's epilogue; the token and padding rows'
    //    logits go unread
    for (int i = gt; i < TP * C; i += kGT) {
      const int p = i / C, c = i - (i / C) * C;
      if (p0 + p < P)
        token_out[(size_t)(p0 + p) * C + c] = __ldg(tokc + I::TOK + c) + Vb[p * L * LD + c];
    }
    float* lg = Kb + MT * 16 * (R1 + R2);   // GR logits
    if (gw < MT) {
      const int r0 = gw * 16;
      float* h1 = Kb + gw * 16 * (R1 + R2);  // 16 x R1
      float* h2 = h1 + 16 * R1;              // 16 x R2
      gemm<1, 1, R1, I::KR, XK, XS, true, C, LD, false>(
          Xb + r0 * XS, Vb + r0 * LD, Ws + I::VRAD, 0, [&](int r, int c, float v0, float v1) {
            const int p = min((r0 + r) / L, TP - 1);
            const float2 b = *reinterpret_cast<const float2*>(Tb + p * LT + C2 + c);
            *reinterpret_cast<float2*>(h1 + r * R1 + c) =
                make_float2(fmaxf(v0 + b.x, 0.f), fmaxf(v1 + b.y, 0.f));
          });
      __syncwarp();
      warp_linear(h1, R1, R1, Ws + I::RW1, I::KR1, F + I::RB1, h2, R2, R2, true);
      __syncwarp();
      warp_linear(h2, R2, R2, Ws + I::RW2, I::KR2, F + I::RB2, lg + r0, 1, 1, false);
    }
    group_sync<kGT>(grp);
    PH2F_MARK(9);

    // 9. the masked softmax over each point's views and the rgb blend, in
    //     point_head2.cuh's order; a point masked in every view gets
    //     uniform weights (the mean rgb), as the JAX softmax does
    for (int p = gt; p < TP; p += kGT) {
      const int gp = p0 + p;
      if (gp >= P) continue;
      float logit[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        logit[v] = Vb[(p * L + 1 + v) * LD + C + 3] == 0.f ? -1e9f : lg[p * L + 1 + v];
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
          acc = fmaf(Vb[(p * L + 1 + v) * LD + C + ch], logit[v] / sum, acc);
        rad_out[(size_t)gp * 3 + ch] = acc;
      }
    }
    // the next tile overwrites the group's buffers
    group_sync<kGT>(grp);
    PH2F_MARK(10);
  }
}

template <int CV, int NV>
int launch_nv(const float* img, const float* vol, const float* sim, const float* dd,
              const float* dir, const float* rgb, const float* mask, const float* w,
              float* token, float* rad, int p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CV, NV>();
  static_assert(smem <= 232448, "more shared memory than an sm_90 block may have");
  cudaError_t e = cudaFuncSetAttribute(point_head2_fast_kernel<CV, NV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  using T = Tiling<NV>;
  const int tiles = (p + T::TP - 1) / T::TP;
  const int pairs = (tiles + T::kGroups - 1) / T::kGroups;
  point_head2_fast_kernel<CV, NV><<<pairs < sms ? pairs : sms, kThreads, smem, stream>>>(
      img, vol, sim, dd, dir, rgb, mask, reinterpret_cast<const uint16_t*>(w), token, rad, p);
  return (int)cudaGetLastError();
}

#define UFO_PH2F_ARGS                                                            \
  const float *img, const float *vol, const float *sim, const float *dd,        \
      const float *dir, const float *rgb, const float *mask, const float *w,    \
      float *token, float *rad
#define UFO_PH2F_CASE(NV) \
  case NV: return launch_nv<CV, NV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, p, s);

// NV 6..11 (point_head2_fast_views.cu; cudaErrorInvalidValue otherwise)
template <int CV>
int launch_views(UFO_PH2F_ARGS, int nv, int p, cudaStream_t s);

}  // namespace ph2f
}  // namespace ufo
