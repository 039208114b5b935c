// Fused per-point view head for Hopper (sm_90a), kernel_precision 'fast'.
//
// Replaces the Pallas TPU kernel point_head_fused (body _kernel) of the
// JAX package's ops/fused_point_head.py in its 'fast' mode: the single
// bf16 pass at its kernel_dot sites (fused_point_head.py:138-143: the
// pre-similarity MLP, q/k/v, merge, mlp1, mlp2 and the radiance MLP; both
// operands rounded to bf16, the exact products summed in FP32), the
// attention, LayerNorms and softmax in FP32. The function and the token
// layout are point_head.cuh's; this is its bf16 design at NV 2..5
// (point_head_fast_views.cu, on the same pack, sums its products by FP32
// FMAs at NV 6..11; past 11 views point_head_stream.cu takes both
// precisions).
//
// What bounds it on the H100: the bf16 tensor cores, ~2.6e5 multiply-adds
// a point at NV 3 against ~1 KB in and out (0.0397 ms at P = 65,536, the
// bound chip_smoke prints: the layers and both small MLPs as bf16
// products, the attention in FP32). The first bf16 design (the 3xTF32
// kernel's structure with bf16 operands, 1.07 ms, 3.7 % of the bound)
// spent its time around the products: each block of 16 points streamed
// the weight pack from the L2 through a two-slot cp.async ring with a
// block-wide sync per k step (40 a block), the weights stored as FP32
// words, and the two small MLPs ran as FP32 FMAs a few warps at a time
// between block-wide syncs.
//
// Design:
//   * Persistent blocks of 512 threads, one an SM. Every bf16 weight of
//     the head (q | k | v, merge, mlp1, mlp2 and both small MLPs) and the
//     LayerNorms' and small MLPs' FP32 vectors (146,352 bytes at tokens of
//     80) arrive once per block by TMA bulk copies completing on an
//     mbarrier and stay in shared memory (the view token, read once a
//     tile, follows them in the pack and stays in global memory), each matrix as its torch (out,
//     in) rows, kpad apart, so that a B fragment is one conflict-free
//     32-bit load. The rest of the 232,448 bytes holds 64 token rows of
//     activations (X, Q, K, V of C + 4 floats a row).
//   * Two groups of 8 warps, each owning its own tile of 32 token rows
//     (10, 8, 6, 5 points at NV 2..5) and syncing on its own named
//     barrier, so that one group's latency-bound phases (loads, attention,
//     LayerNorm, softmax) overlap the other's products (Tiling).
//   * Each product's shapes are compile-time (group_gemm): q, k and v are
//     one product of N = 3C with phi in its epilogue; each warp owns all
//     the group's m16 tiles and every kWarps-th n8 tile, so a B fragment
//     serves every m tile. Operands that only a product reads (the
//     attention output, the message, mlp1's output) are stored
//     bf16-rounded.
//   * A view row's dir_rel and mask sit in its X row's padding columns
//     C..C+3 and its rgb in its V row's, loaded with the tile's inputs: X's
//     first C + 3 columns are the radiance MLP's input as they stand, and
//     the softmax reads no global memory. The pre-similarity MLP (one warp)
//     runs beside the NeRF PE (the other warps); the radiance MLP runs a
//     warp per 16 rows; both inside their warps on the tensor cores, with
//     only __syncwarp between layers. LayerNorm takes a row on eight
//     threads (three shuffles a sum). Eleven group barriers a tile.
//
// What bounds it now (H100 at P = 65,536, NV 3; script/head_variants.py
// phf,phf_probe, cycles a tile of one group): latency. The products take
// ~16,000 of ~35,000 cycles a tile (mma.sync at a few % of the tensor
// cores' rate: each k step waits on its fragment loads, and the A
// fragments, FP32 in shared memory, are loaded by every warp of the
// group), the loads and the pre-similarity MLP ~7,500 (a DRAM round trip
// and a chain of three small layers), the LayerNorms ~5,000. Two tiles in
// flight an SM, as shared memory allows beside the resident weights, do
// not hide that. wgmma would need 64-row tiles a warpgroup and operand
// tiles in its swizzled layouts in shared memory that is already full;
// bf16 copies of the operands (ldmatrix) and prefetching the next tile's
// inputs need room that the weights take.
#pragma once

#include "point_head.cuh"

namespace ufo {
namespace phf {

using ph::CI;
using ph::Dims;
using ph::kPi;
using ph::NH;
using ph::PE;
using ph::R1;
using ph::R2;
using ph::SH;
using ph::SIN;
using ph::SOUT;

constexpr int kThreads = 512;
constexpr int kRows = 64;         // token rows a block holds, over its groups
constexpr int kPiece = 32768;     // bytes a bulk copy moves at most

// The tiling at NV views: two groups of 8 warps, each on its own tile of
// GR = 32 token rows (two m16 tiles), so that one group's latency-bound
// phases overlap the other's.
template <int NV>
struct Tiling {
  static constexpr int kGroups = 2;
  static constexpr int kWarps = kThreads / 32 / kGroups;
  static constexpr int kGroupThreads = 32 * kWarps;
  static constexpr int GR = kRows / kGroups;
  static constexpr int MT = GR / 16;
  static constexpr int TP = GR / (NV + 1);   // points of a tile
};

// bf16 row stride of a matrix of k inputs: k rounded up to 8, or 8 more,
// whichever makes the stride in 32-bit words an odd multiple of 4 (B
// fragments then hit 32 distinct banks)
__host__ __device__ constexpr int kpad(int k) {
  return ((k + 7) / 8 * 8 / 2) % 8 == 4 ? (k + 7) / 8 * 8 : (k + 7) / 8 * 8 + 8;
}

// The weight pack (fused_point_head.fast_image): the image a block copies
// into shared memory, the layers' and the small MLPs' bf16 matrices, each
// as its torch (out, in) rows kpad(in) apart (the last radiance layer's
// one row padded to 8 with zero rows), offsets in bf16 elements, then FP32
// the LayerNorms' scales and biases and the small MLPs' biases, offsets in
// floats from F32; after the image (BYTES) the view token's C floats.
template <int CV>
struct Img {
  static constexpr int C = Dims<CV>::C, C2 = Dims<CV>::C2, CR = Dims<CV>::CR;
  static constexpr int KC = kpad(C), KC2 = kpad(C2);
  static constexpr int KS0 = kpad(SIN), KS = kpad(SH), KR0 = kpad(CR), KR1 = kpad(R1),
                       KR2 = kpad(R2);
  static constexpr int QKV = 0;                  // wq, wk, wv: 3C rows
  static constexpr int WM = QKV + 3 * C * KC;
  static constexpr int W1 = WM + C * KC;         // in: [token | message]
  static constexpr int W2 = W1 + C2 * KC2;
  static constexpr int SW0 = W2 + C * KC2;       // pre-similarity MLP
  static constexpr int SW1 = SW0 + SH * KS0;
  static constexpr int SW2 = SW1 + SH * KS;
  static constexpr int RW0 = SW2 + SOUT * KS;    // radiance MLP
  static constexpr int RW1 = RW0 + R1 * KR0;
  static constexpr int RW2 = RW1 + R2 * KR1;
  static constexpr int NB = RW2 + 8 * KR2;
  static constexpr int N1S = 0, N1B = C, N2S = 2 * C, N2B = 3 * C;
  static constexpr int SB0 = 4 * C, SB1 = SB0 + SH, SB2 = SB1 + SH;
  static constexpr int RB0 = SB2 + SOUT, RB1 = RB0 + R1, RB2 = RB1 + R2;
  static constexpr int NF = RB2 + 4;             // floats, the last bias padded
  static constexpr int F32 = 2 * NB;             // byte offset of the FP32 part
  static constexpr int BYTES = F32 + 4 * NF;     // what a block copies
  static constexpr int PACK = BYTES + 4 * C;     // and the view token
  static_assert(NB % 8 == 0 && NF % 4 == 0, "bulk copies move multiples of 16 bytes");
};

template <int CV>
constexpr size_t smem_bytes() {
  return Img<CV>::BYTES + 16 + sizeof(float) * (size_t)4 * kRows * Dims<CV>::LD;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kGroupThreads>
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(kGroupThreads) : "memory");
}

// With UFO_PHF_PROBE defined (script/head_variants.py's phf_probe), thread
// 0 of block 0 adds each phase's cycles, barrier included, to phf_probe[i]
// and counts its tiles in phf_probe[15] (ufo_point_head_fast_probe reads
// them).
#ifdef UFO_PHF_PROBE
static __device__ unsigned long long phf_probe[16];
#define PHF_MARK(i)                                       \
  if (blockIdx.x == 0 && threadIdx.x == 0) {              \
    const unsigned long long now = clock64();             \
    phf_probe[i] += now - probe_t0;                       \
    probe_t0 = now;                                       \
    if ((i) == 10) ++phf_probe[15];                       \
  }
#else
#define PHF_MARK(i)
#endif

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// out[r, c] = sum_k a[r, k] W[k, c] over the group's T::GR rows and N
// columns, a = [a1 (K1 columns, stride LDA1) | a2 (K2, LDA2)] FP32 in
// shared memory (K1, K2 multiples of 8), W as its (N, KP) bf16 rows in
// shared memory; the shapes are compile-time, so the k loop unrolls and
// its addresses fold. Each warp (gw of the group's T::kWarps) owns all
// T::MT m16 tiles and the n8 tiles gw, gw + T::kWarps, ...; epi(row, col, v0,
// v1) stores columns col, col + 1.
template <class T, int N, int KP, int K1, int LDA1, int K2, int LDA2, typename Epi>
__device__ __forceinline__ void group_gemm(const float* a1, const float* a2,
                                           const uint16_t* wt, int gw, Epi epi) {
  constexpr int kGroupWarps = T::kWarps, MT = T::MT;
  constexpr int NTILES = N / 8, K = K1 + K2;
  constexpr int NT = (NTILES + kGroupWarps - 1) / kGroupWarps;
  static_assert(K1 % 8 == 0 && K2 % 8 == 0 && N % 8 == 0, "whole 8-wide tiles");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[NT][MT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[i][m][0] = acc[i][m][1] = acc[i][m][2] = acc[i][m][3] = 0.f;
  const float* r1 = a1 + g * LDA1;    // row g of m tile 0
  const float* r2 = a2 + g * LDA2;
  const uint16_t* wg = wt + g * KP + 2 * t;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kc = kk + 8 * h;   // compile-time: which operand, or zeros
        if (kc < K) {
          const float* ar = kc < K1 ? r1 + m * 16 * LDA1 + kc + 2 * t
                                    : r2 + m * 16 * LDA2 + kc - K1 + 2 * t;
          const int lda = kc < K1 ? LDA1 : LDA2;
          const float2 top = *reinterpret_cast<const float2*>(ar);
          const float2 bot = *reinterpret_cast<const float2*>(ar + 8 * lda);
          a[m][2 * h] = bf16x2_rn(top.x, top.y);
          a[m][2 * h + 1] = bf16x2_rn(bot.x, bot.y);
        } else {
          a[m][2 * h] = a[m][2 * h + 1] = 0u;
        }
      }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int j = gw + kGroupWarps * i;
      if (j < NTILES) {
        const uint16_t* wc = wg + j * 8 * KP + kk;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(wc);
        // past K the activations are zero and the weights read are the
        // row's padding or the next row's (finite)
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(wc + 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) tc::mma_bf16(acc[i][m], a[m], b0, b1);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int j = gw + kGroupWarps * i;
    if (j < NTILES) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        epi(m * 16 + g, 8 * j + 2 * t, acc[i][m][0], acc[i][m][1]);
        epi(m * 16 + g + 8, 8 * j + 2 * t, acc[i][m][2], acc[i][m][3]);
      }
    }
  }
}

// A small dense layer on one warp's 16 rows: out[r, c] = act(b[c] + sum_k
// a[r, k] W[k, c]), r < 16, c < n; a FP32 in shared memory (lda; columns
// up to k rounded to 16 readable and finite), W as its (n, kw) bf16 rows
// and b FP32, both in shared memory, on the tensor cores (bias as the
// sums' start, bf16-rounded activations). The caller __syncwarp()s
// between layers.
__device__ __forceinline__ void warp_linear(const float* a, int lda, int k, const uint16_t* w,
                                            int kw, const float* b, float* out, int ldo, int n,
                                            bool relu) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto av = [&](int r, int kk) { return kk < k ? a[r * lda + kk] : 0.f; };
  for (int n0 = 0; n0 < n; n0 += 8) {
    const int col = n0 + 2 * t;
    const float b0 = col < n ? b[col] : 0.f, b1 = col + 1 < n ? b[col + 1] : 0.f;
    float acc[4] = {b0, b1, b0, b1};
    const uint16_t* wc = w + (n0 + g) * kw + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 96; kk += 16) {
      if (kk < k) {
        const int ka = kk + 2 * t;
        const uint32_t af[4] = {bf16x2_rn(av(g, ka), av(g, ka + 1)),
                                bf16x2_rn(av(g + 8, ka), av(g + 8, ka + 1)),
                                bf16x2_rn(av(g, ka + 8), av(g, ka + 9)),
                                bf16x2_rn(av(g + 8, ka + 8), av(g + 8, ka + 9))};
        // past k the activations are zero; the weights read there are
        // the row's padding (finite), or nothing at all past its stride
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wc + kk);
        const uint32_t w1 = kk + 8 < kw ? *reinterpret_cast<const uint32_t*>(wc + kk + 8) : 0u;
        tc::mma_bf16(acc, af, w0, w1);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (col < n) out[r * ldo + col] = relu ? fmaxf(acc[2 * h], 0.f) : acc[2 * h];
      if (col + 1 < n)
        out[r * ldo + col + 1] = relu ? fmaxf(acc[2 * h + 1], 0.f) : acc[2 * h + 1];
    }
  }
}

// common.cuh's phi without a branch: the exp is taken either way (of 0
// above zero; a NaN stays NaN), so the q | k | v epilogue's warps do not
// diverge. The same values; common.cuh keeps the branch, which the
// streamed ray head runs faster (its SN 256 case took 12 % longer with
// this form on the H100).
__device__ __forceinline__ float phi_sel(float x) {
  const float e = expf(x > 0.f ? 0.f : x);
  return x > 0.f ? x + 1.f : e;
}

// LayerNorm (eps kLnEps, two-pass mean and variance) over the C features
// of each of the group's rows, eight threads a row, each taking the
// columns part, part + 8, ... and the row's sums over three shuffles (the
// latency of a warp-wide sum, five shuffles a row, queued behind the other
// group's shared-memory loads, was most of this phase's time). Scale and
// bias in shared memory. out(row, col, y) takes each result (the row's
// values are in registers by then, so it may write x). No sync.
template <int C, int kGroupThreads, typename Out>
__device__ __forceinline__ void group_layernorm(const float* x, int ld, int rows, int gt,
                                                const float* scale, const float* bias, Out out) {
  constexpr int J = (C + 7) / 8;
  const int part = gt & 7;
  for (int r = gt >> 3; r < rows; r += kGroupThreads / 8) {
    float v[J];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = part + 8 * j;
      v[j] = c < C ? x[r * ld + c] : 0.f;
      s += v[j];
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    const float mean = s / C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (part + 8 * j < C) {
        const float d = v[j] - mean;
        q += d * d;
      }
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    q += __shfl_xor_sync(0xffffffffu, q, 4);
    const float inv = rsqrtf(q / C + kLnEps);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = part + 8 * j;
      if (c < C) out(r, c, (v[j] - mean) * inv * scale[c] + bias[c]);
    }
  }
}

template <int CV, int NV>
__global__ void __launch_bounds__(kThreads, 1) point_head_fast_kernel(
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
  constexpr int C = D::C, DK = D::DK, C2 = D::C2, CR = D::CR, LD = D::LD, LD2 = D::LD2;
  constexpr int L = NV + 1;
  using T = Tiling<NV>;
  constexpr int kGroups = T::kGroups, kGroupWarps = T::kWarps,
                kGroupThreads = T::kGroupThreads, GR = T::GR, MT = T::MT, TP = T::TP;
  static_assert(TP >= 1 && TP <= 16, "a tile's points: one warp's pre-similarity rows");
  static_assert(LD2 <= 2 * LD && CR + 1 <= LD && MT <= kGroupWarps,
                "the buffers hold what the kernel puts there");
  extern __shared__ float4 smem4[];
  uint16_t* Ws = reinterpret_cast<uint16_t*>(smem4);
  const float* F = reinterpret_cast<const float*>(reinterpret_cast<char*>(smem4) + I::F32);
  const float* tok = reinterpret_cast<const float*>(reinterpret_cast<const char*>(wimg) +
                                                    I::BYTES);
  auto* bar = reinterpret_cast<unsigned long long*>(reinterpret_cast<char*>(smem4) + I::BYTES);
  const int grp = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x - grp * kGroupThreads;   // thread of the group
  const int gw = gt >> 5;
  float* X = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + I::BYTES + 16) +
             grp * 4 * GR * LD;      // GR x LD tokens, later the layer output
  float* Qb = X + GR * LD;           // q | k | v, one after another
  float* Kb = Qb + GR * LD;
  float* Vb = Kb + GR * LD;

  // the weight image, once per block: thread 0 starts the bulk copies,
  // every thread waits for them before its first layer product
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
#ifdef UFO_PHF_PROBE
    unsigned long long probe_t0 = clock64();
#endif
    const int p0 = tile * TP;
    const bool full = p0 + TP <= P;
    // 1. inputs. Image and volume features straight into the view rows of
    //    X (cp.async where the tile is whole); raw cosines and depth
    //    distances to scratch; each view row's dir_rel and mask into its
    //    X row's columns C..C+3 and its rgb into its Vb row's (the rows'
    //    padding, which no product reads: [token | dir] is then the
    //    radiance MLP's input as it stands); the view-token rows; the
    //    padding rows zero, finite all through
    float* s_in = Qb;               // 16 x SIN
    float* s_h1 = s_in + 16 * SIN;  // 16 x SH
    float* s_h2 = s_h1 + 16 * SH;   // 16 x SH
    float* s16 = s_h2 + 16 * SH;    // 16 x SOUT
    float* dds = Kb;                // NV x TP
    if (full) {
      for (int i = gt; i < NV * TP * (CI / 4); i += kGroupThreads) {
        const int v = i / (TP * (CI / 4)), p = (i / (CI / 4)) % TP, c4 = i % (CI / 4);
        tc::cp_async16(X + (p * L + 1 + v) * LD + 4 * c4,
                       img + ((size_t)v * P + p0 + p) * CI + 4 * c4);
      }
      for (int i = gt; i < NV * TP * (CV / 4); i += kGroupThreads) {
        const int v = i / (TP * (CV / 4)), p = (i / (CV / 4)) % TP, c4 = i % (CV / 4);
        tc::cp_async16(X + (p * L + 1 + v) * LD + CI + 4 * c4,
                       vol + (size_t)(p0 + p) * CV + 4 * c4);
      }
    } else {
      for (int i = gt; i < NV * TP * (CI + CV); i += kGroupThreads) {
        const int v = i / (TP * (CI + CV)), p = (i / (CI + CV)) % TP, c = i % (CI + CV);
        const int gp = p0 + p;
        float val = 0.f;
        if (gp < P)
          val = c < CI ? img[((size_t)v * P + gp) * CI + c] : vol[(size_t)gp * CV + c - CI];
        X[(p * L + 1 + v) * LD + c] = val;
      }
    }
    tc::cp_async_commit();
    for (int i = gt; i < 16 * SIN; i += kGroupThreads) {
      const int p = i / SIN, gp = p0 + p;
      s_in[i] = p < TP && gp < P ? __ldg(sim + (size_t)gp * SIN + i % SIN) : 0.f;
    }
    for (int i = gt; i < NV * TP; i += kGroupThreads) {
      const int v = i / TP, p = i % TP, gp = p0 + p;
      const bool in = gp < P;
      const size_t pv = (size_t)v * P + gp;
      float* xr = X + (p * L + 1 + v) * LD + C;
      float* vr = Vb + (p * L + 1 + v) * LD + C;
      dds[i] = in ? __ldg(dd + pv) : 0.f;
      xr[0] = in ? __ldg(dir + pv * 3) : 0.f;
      xr[1] = in ? __ldg(dir + pv * 3 + 1) : 0.f;
      xr[2] = in ? __ldg(dir + pv * 3 + 2) : 0.f;
      xr[3] = in ? __ldg(mask + pv) : 0.f;
      vr[0] = in ? __ldg(rgb + pv * 3) : 0.f;
      vr[1] = in ? __ldg(rgb + pv * 3 + 1) : 0.f;
      vr[2] = in ? __ldg(rgb + pv * 3 + 2) : 0.f;
    }
    for (int i = gt; i < TP * LD; i += kGroupThreads)
      X[(i / LD) * L * LD + i % LD] = i % LD < C ? __ldg(tok + i % LD) : 0.f;
    for (int i = gt; i < (GR - TP * L) * LD; i += kGroupThreads) X[TP * L * LD + i] = 0.f;
    if (!weights_in) {
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
      weights_in = true;
    }
    group_sync<kGroupThreads>(grp);
    PHF_MARK(0);

    // 2. one warp: the pre-similarity MLP, its 16 outputs into each view
    //    row of its point; the others: each view row's NeRF PE of its
    //    depth distance (zero for points past P)
    if (gw == 0) {
      warp_linear(s_in, SIN, SIN, Ws + I::SW0, I::KS0, F + I::SB0, s_h1, SH, SH, true);
      __syncwarp();
      warp_linear(s_h1, SH, SH, Ws + I::SW1, I::KS, F + I::SB1, s_h2, SH, SH, true);
      __syncwarp();
      warp_linear(s_h2, SH, SH, Ws + I::SW2, I::KS, F + I::SB2, s16, SOUT, SOUT, false);
      __syncwarp();
      for (int i = gt; i < NV * TP * SOUT; i += 32) {
        const int v = i / (TP * SOUT), p = (i / SOUT) % TP, c = i % SOUT;
        X[(p * L + 1 + v) * LD + CI + CV + c] = p0 + p < P ? s16[p * SOUT + c] : 0.f;
      }
    } else {
      for (int i = gt - 32; i < NV * TP * PE; i += kGroupThreads - 32) {
        const int v = i / (TP * PE), p = (i / PE) % TP, k = i % PE;
        float val = 0.f;
        if (p0 + p < P) {
          const float f = ldexpf(kPi, k >> 1);
          const float ph = (k & 1) ? 0.5f * kPi : 0.f;
          // the product and the sum rounded apart, as the plain version's
          // x * f + ph (an FMA would round once)
          val = sinf(__fadd_rn(__fmul_rn(dds[v * TP + p], f), ph));
        }
        X[(p * L + 1 + v) * LD + CI + CV + SOUT + k] = val;
      }
    }
    tc::cp_async_wait<0>();
    group_sync<kGroupThreads>(grp);
    PHF_MARK(1);

    // 3. q | k | v in one product, phi of q and k in its epilogue
    group_gemm<T, 3 * C, I::KC, C, LD, 0, LD>(
        X, nullptr, Ws + I::QKV, gw, [&](int r, int c, float v0, float v1) {
          const int which = c / C;
          if (which < 2) { v0 = phi_sel(v0); v1 = phi_sel(v1); }
          *reinterpret_cast<float2*>(Qb + which * GR * LD + r * LD + c - which * C) =
              make_float2(v0, v1);
        });
    group_sync<kGroupThreads>(grp);
    PHF_MARK(2);

    // 4. linear attention among each point's L tokens, per head; the
    //    thread of (row, head) overwrites its q with the output, rounded to
    //    bf16 (merge's operand only)
    for (int it = gt; it < TP * L * NH; it += kGroupThreads) {
      const int r = it / NH, h = it - (it / NH) * NH;
      const int base = (r / L) * L;
      float q[DK], acc[DK];
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        q[d] = Qb[r * LD + h * DK + d];
        acc[d] = 0.f;
      }
      float den = 0.f;
#pragma unroll
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
      for (int d = 0; d < DK; ++d) Qb[r * LD + h * DK + d] = bf16_round(acc[d] / den);
    }
    group_sync<kGroupThreads>(grp);
    PHF_MARK(3);

    // 5. merge -> Vb (v is dead; its padding columns keep the rgb), then
    //    LayerNorm, the message stored bf16-rounded (mlp1's operand only)
    auto store = [](float* out, int ld, bool relu) {
      return [=](int r, int c, float v0, float v1) {
        // mlp1's output is only mlp2's operand: stored bf16-rounded
        if (relu) { v0 = bf16_round(fmaxf(v0, 0.f)); v1 = bf16_round(fmaxf(v1, 0.f)); }
        *reinterpret_cast<float2*>(out + r * ld + c) = make_float2(v0, v1);
      };
    };
    group_gemm<T, C, I::KC, C, LD, 0, LD>(Qb, nullptr, Ws + I::WM, gw, store(Vb, LD, false));
    group_sync<kGroupThreads>(grp);
    PHF_MARK(4);
    group_layernorm<C, kGroupThreads>(Vb, LD, GR, gt, F + I::N1S, F + I::N1B,
                          [&](int r, int c, float y) { Vb[r * LD + c] = bf16_round(y); });
    group_sync<kGroupThreads>(grp);
    PHF_MARK(5);
    // 6. mlp1 over [tokens | message] -> Qb|Kb (GR x LD2), relu
    group_gemm<T, C2, I::KC2, C, LD, C, LD>(X, Vb, Ws + I::W1, gw, store(Qb, LD2, true));
    group_sync<kGroupThreads>(grp);
    PHF_MARK(6);
    // 7. mlp2 -> Vb, its LayerNorm added into X (the residual)
    group_gemm<T, C, I::KC2, C2, LD2, 0, LD2>(Qb, nullptr, Ws + I::W2, gw, store(Vb, LD, false));
    group_sync<kGroupThreads>(grp);
    PHF_MARK(7);
    group_layernorm<C, kGroupThreads>(Vb, LD, GR, gt, F + I::N2S, F + I::N2B,
                          [&](int r, int c, float y) { X[r * LD + c] += y; });
    group_sync<kGroupThreads>(grp);
    PHF_MARK(8);

    // 8. the view-token output; the radiance MLP over every row's [token
    //    out | dir_rel] (X's first CR columns), a warp per 16 rows; the
    //    view-token and padding rows' logits go unread
    for (int i = gt; i < TP * C; i += kGroupThreads) {
      const int p = i / C, c = i - (i / C) * C;
      if (p0 + p < P) token_out[(size_t)(p0 + p) * C + c] = X[p * L * LD + c];
    }
    float* lg = Kb + MT * 16 * (R1 + R2);   // GR logits
    if (gw < MT) {
      float* h1 = Kb + gw * 16 * (R1 + R2);  // 16 x R1
      float* h2 = h1 + 16 * R1;              // 16 x R2
      warp_linear(X + gw * 16 * LD, LD, CR, Ws + I::RW0, I::KR0, F + I::RB0, h1, R1, R1, true);
      __syncwarp();
      warp_linear(h1, R1, R1, Ws + I::RW1, I::KR1, F + I::RB1, h2, R2, R2, true);
      __syncwarp();
      warp_linear(h2, R2, R2, Ws + I::RW2, I::KR2, F + I::RB2, lg + gw * 16, 1, 1, false);
    }
    group_sync<kGroupThreads>(grp);
    PHF_MARK(9);

    // 9. the masked softmax over each point's views and the rgb blend, in
    //    point_head.cuh's order; a point masked in every view gets
    //    uniform weights (the mean rgb), as the JAX softmax does
    for (int p = gt; p < TP; p += kGroupThreads) {
      const int gp = p0 + p;
      if (gp >= P) continue;
      float logit[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        logit[v] = X[(p * L + 1 + v) * LD + C + 3] == 0.f ? -1e9f : lg[p * L + 1 + v];
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
    group_sync<kGroupThreads>(grp);
    PHF_MARK(10);
  }
}

template <int CV, int NV>
int launch_nv(const float* img, const float* vol, const float* sim, const float* dd,
              const float* dir, const float* rgb, const float* mask, const float* w,
              float* token, float* rad, int p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CV>();
  static_assert(smem <= 232448, "more shared memory than an sm_90 block may have");
  cudaError_t e = cudaFuncSetAttribute(point_head_fast_kernel<CV, NV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  using T = Tiling<NV>;
  const int tiles = (p + T::TP - 1) / T::TP;
  const int pairs = (tiles + T::kGroups - 1) / T::kGroups;
  point_head_fast_kernel<CV, NV><<<pairs < sms ? pairs : sms, kThreads, smem, stream>>>(
      img, vol, sim, dd, dir, rgb, mask, reinterpret_cast<const uint16_t*>(w), token, rad, p);
  return (int)cudaGetLastError();
}

#define UFO_PHF_CASE(NV)                                                                   \
  case NV:                                                                                 \
    return phf::launch_nv<CV, NV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, p, s);

}  // namespace phf
}  // namespace ufo
