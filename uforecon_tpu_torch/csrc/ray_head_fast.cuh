// Fused along-ray SRDF head for Hopper (sm_90a), kernel_precision 'fast',
// at every token width a JAX flag set gives (40 .. 112 in steps of 8; one
// translation unit each, ray_head_fast*.cu).
//
// Replaces the Pallas TPU kernels ray_head_fused (body _kernel) and
// ray_head_neus_fused (body _kernel_neus / _neus_epilogue) of the JAX
// package's ops/fused_ray_head.py in their 'fast' mode: the single bf16 pass
// at the kernel_dot sites (fused_ray_head.py:85-87, 108-126): q, k, v,
// merge, mlp1, mlp2, the density MLP and the linear-attention sums kv =
// sum_s phi(k_s) v_s^T, num = phi(q) kv and den = phi(q) ksum, both operands
// rounded to bf16 (to nearest even), the exact products summed in FP32;
// ksum the FP32 sum of the unrounded phi(k), the LayerNorms in FP32. It is
// ray_head.cu's kFast instance redesigned, outputs bit for bit the same:
// every product, sum and rounding as there, in the same order (the layers'
// mma.m16n8k16 k16 steps, the state and ksum in sample order, den and num
// in feature order, the LayerNorms' warp sums, the density MLP's FMAs from
// the bias). Widths below 40 stay on that instance (no JAX flag set gives
// them).
//
// What bounds it on the H100: the bf16 tensor cores. At C 88 a sample
// costs ~8.3e4 multiply-adds (the layers, the density MLP, the per-head
// attention sums) against 352 bytes in and 4 out: 0.0334 ms for a 1024-ray
// chunk at SN 64 + 128 (chip_smoke.py's bf16 bound). The first bf16 design
// (ray_head.cu's 3xTF32 structure with bf16 operands, 1.08 ms a chunk)
// spent its time around the products: one 512-thread block a ray streamed
// every weight from the L2 through a two-slot cp.async ring with a
// block-wide sync each k16 step (~46 a tile), the weights stored as FP32
// words, and the rest of the layer ran between block-wide syncs.
//
// Design:
//   * Persistent blocks of 256 threads, one an SM. Every bf16 weight of the
//     head and the FP32 LayerNorm and density vectors (fast_image: 167,696
//     bytes at C 88) arrive once per block by TMA bulk copies completing on
//     an mbarrier and stay in shared memory, each matrix as its torch (out,
//     in) rows kpad apart, so that a B fragment is one conflict-free 32-bit
//     load. From C 96 on the image and the two groups' buffers pass the
//     232,448 bytes a block may have (345,312 at C 112), so those widths
//     take the wide layout (ImgW): mlp1, the largest matrix, and the
//     density MLP's first two stay in global memory, read through the L2
//     (mlp1 in B-fragment order, one 16-byte load a lane and k16 step for
//     two n8 tiles, not allocated in the L1; the density weights cached
//     there), the rest resident as before: 232,416 bytes at C 112. Not
//     taken: a pair of blocks (a cluster) splitting the image between their
//     shared memories, each reading half its B fragments from the other SM
//     (at C 88, half the image read that way took 2.6x the resident
//     kernel's time: head_variants.py rhf,rhf_dsmem); one group a block
//     with room for mlp1 (half the warps an SM: 1.5x at C 88 and 112,
//     rhf,G=1).
//   * Two groups of four warps, each walking its own rays and syncing on its
//     own named barrier, so that one ray's loads, sums and epilogues overlap
//     the other's products.
//   * Phase 1, a chunk of 64 samples at a time (any SN): a warp's 16 samples
//     through k (phi, FP32, staged for ksum) and v (bf16) on the tensor
//     cores; then a thread per feature adds ksum and its head's row of kv,
//     FMAs in sample order, in registers across chunks.
//   * Phase 2, a warp per 16 samples, independent of the others: the
//     products in registers, each one's accumulators, rounded to bf16 in
//     pairs, the next one's A fragments (an m16n8 tile's C layout is the
//     m16k16 A layout of two of them): q, merge, mlp1 as one product of
//     depth 2C over [tokens | message], 16 outputs at a time, each at once
//     a k16 step of mlp2. The attention (a lane per sample and head), the
//     LayerNorms (warp sums) and the density MLP (a lane per output) go
//     through the warp's 16-row scratch, a quarter of the chunk buffers.
//   * NeuS (kNeus): once a ray's srdf is in global memory, one warp
//     composites it, 32 samples a step; the transmittance is the serial
//     product in torch.cumprod's order, taken by every lane at once over
//     the step's 32 factors (a shuffle each), so each lane holds its own.
//
// What bounds it now (H100, 1024 rays at C 88; script/head_variants.py
// rhf,rhf_probe): 0.134 / 0.270 ms at SN 64 / 128, ~61,000 cycles a
// 64-sample ray on a group's first thread, of which the products take a
// few %: kFast's FP32 sums on the CUDA cores (the LayerNorms ~25 % of the
// time, the density MLP's first layer ~15 %, the attention ~10 %, the
// state and ksum), each a latency-bound chain at 8 warps an SM. With
// tensor-core sums for the state, num and the density MLP the kernel took
// 0.227 ms a chunk, but the sums no longer kFast's moved chip_smoke.py's
// 12-view chunk one ray past its per-ray rule. At C 112 (--ray_width 112):
// 0.230 / 0.470 ms, ~111,000 cycles a 64-sample ray, of which mlp1 from
// the L2 and mlp2 take ~24,000 (~7,600 at C 88, resident).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "common.cuh"
#include "tc_gemm.cuh"

namespace ufo {
namespace rhf {

constexpr int NH = 8;               // heads
constexpr int D0 = 32, D1 = 16;     // the density MLP's hidden widths
constexpr int kGroups = 2;          // rays in flight a block
constexpr int kGroupWarps = 4;
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kChunk = 64;          // state rows a group holds
constexpr int kPiece = 32768;       // bytes a bulk copy moves at most
// wide layout: mlp1's B fragments in flight, KS2 / kW1Ahead k16 steps ahead
// of the product (a whole slice at 1, half of one at 2 where KS2 is even).
// At C 112 (H100, 1024 rays, SN 64 / 128; head_variants.py rhf,A=N) 1 took
// 0.238 / 0.479 ms, 2 0.230 / 0.470; each slice loaded after the products
// of the one before, 0.252 / 0.519.
constexpr int kW1Ahead = 2;

// bf16 row stride of a matrix of k inputs: k rounded up to 8, or 8 more,
// whichever makes the stride in 32-bit words an odd multiple of 4 (B
// fragments then hit 32 distinct banks)
__host__ __device__ constexpr int kpad(int k) {
  return ((k + 7) / 8 * 8 / 2) % 8 == 4 ? (k + 7) / 8 * 8 : (k + 7) / 8 * 8 + 8;
}

// The weight pack (fused_ray_head.fast_image), the image a block copies
// into shared memory: the bf16 matrices, each as its torch (out, in) rows
// kpad(in) apart, offsets in bf16 elements; then FP32 the LayerNorms'
// scales and biases, the density MLP's biases and its last layer's 16
// weights (bf16-rounded), offsets in floats from F32.
template <int C>
struct Img {
  static constexpr int C2 = 2 * C;
  static constexpr int KC = kpad(C), KC2 = kpad(C2), KD = kpad(D0);
  static constexpr int QKV = 0;                  // wq, wk, wv: 3C rows
  static constexpr int WM = QKV + 3 * C * KC;
  static constexpr int W1 = WM + C * KC;         // in: [token | message]
  static constexpr int W2 = W1 + C2 * KC2;
  static constexpr int DW0 = W2 + C * KC2;
  static constexpr int DW1 = DW0 + D0 * KC;
  static constexpr int NB = DW1 + D1 * KD;
  static constexpr int N1S = 0, N1B = C, N2S = 2 * C, N2B = 3 * C;
  static constexpr int DB0 = 4 * C, DB1 = DB0 + D0, DW2 = DB1 + D1, DB2 = DW2 + D1;
  static constexpr int NF = (DB2 + 1 + 3) / 4 * 4;   // floats, padded to 16 bytes
  static constexpr int F32 = 2 * NB;             // byte offset of the FP32 part
  static constexpr int BYTES = F32 + 4 * NF;
  static constexpr int SHARED = BYTES;           // all of it resident
  static constexpr bool kWide = false;
  static_assert(NB % 8 == 0 && NF % 4 == 0, "bulk copies move multiples of 16 bytes");
};

// The wide layout (C 96 .. 112; fast_image at those widths): what stays in
// shared memory first, copied as Img's is (wq, wk, wv, wmerge, w2 as bf16
// (out, in) rows kpad apart, then Img's FP32 part), then what stays in
// global memory: mlp1 in B-fragment order, its k16 step s of output slice
// c (16 rows) the 32 lanes' 16 bytes {b0, b1 of rows 16c + g, b0, b1 of
// rows 16c + 8 + g} (b0 columns 16s + 2t, + 1; b1 eight on); the density
// MLP's first two matrices as Img holds them. SHARED: the bytes copied;
// W1F, DW0, DW1: byte offsets in the pack.
template <int C>
struct ImgW {
  static constexpr bool kWide = true;
  static constexpr int C2 = 2 * C, KS2 = C2 / 16;
  static constexpr int KC = kpad(C), KC2 = kpad(C2), KD = kpad(D0);
  static constexpr int QKV = 0;
  static constexpr int WM = QKV + 3 * C * KC;
  static constexpr int W2 = WM + C * KC;
  static constexpr int NB = W2 + C * KC2;
  static constexpr int N1S = 0, N1B = C, N2S = 2 * C, N2B = 3 * C;
  static constexpr int DB0 = 4 * C, DB1 = DB0 + D0, DW2 = DB1 + D1, DB2 = DW2 + D1;
  static constexpr int NF = (DB2 + 1 + 3) / 4 * 4;
  static constexpr int F32 = 2 * NB;
  static constexpr int SHARED = F32 + 4 * NF;
  static constexpr int W1F = SHARED;
  static constexpr int DW0 = W1F + KS2 * KS2 * 32 * 16;
  static constexpr int DW1 = DW0 + 2 * D0 * KC;
  static constexpr int BYTES = DW1 + 2 * D1 * KD;
  static_assert(NB % 8 == 0 && NF % 4 == 0 && C2 % 16 == 0, "16-byte pieces");
};

// The byte offset of mlp1's fragments in a wide pack (0 where there are
// none)
template <class I>
__host__ __device__ constexpr int w1f_offset() {
  if constexpr (I::kWide) return I::W1F;
  return 0;
}

// Per group: phi(k) and v of a chunk (bf16, C apart; in its first steps the
// chunk's phi(k) in FP32 over both), the state kv (NH x DK x DK,
// ray_head.cu's order) and ksum (FP32, both bf16-rounded). In phase 2 each
// warp takes a quarter of the chunk buffers (16 x SCR FP32) as its scratch:
// 16 rows of C features, or of the density MLP's 32 + 16 hidden values
// where C is narrower (C 40).
template <int C>
struct Group {
  static constexpr int SCR = C > D0 + D1 ? C : D0 + D1;
  static constexpr int PK = kChunk * SCR + 8;    // bf16 elements
  static constexpr int KV = NH * (C / NH) * (C / NH);
  static constexpr int BYTES = 2 * 2 * PK + 4 * KV + 4 * C;
};

constexpr int kSmemLimit = 232448;   // bytes of shared memory an sm_90 block may have

// The layout of width C: Img where the image, the mbarrier and the two
// groups fit a block's shared memory, else ImgW.
template <int C>
using Layout = std::conditional_t<(Img<C>::BYTES + 16 + kGroups * Group<C>::BYTES <= kSmemLimit),
                                  Img<C>, ImgW<C>>;

// Shared memory: the resident image (Layout's SHARED bytes), the mbarrier,
// then the groups' buffers.
template <int C>
struct Smem {
  static constexpr int PK = Group<C>::PK;
  static constexpr int KV = Group<C>::KV;
  static constexpr int GROUP = Group<C>::BYTES;
  static constexpr int BAR = Layout<C>::SHARED;
  static constexpr int GROUPS = BAR + 16;
  static constexpr int BYTES = GROUPS + kGroups * GROUP;
  static_assert(GROUP % 16 == 0 && KV % 8 == 0, "16-byte aligned group buffers");
  static_assert(kChunk * C * 4 <= 2 * 2 * PK && kChunk == 16 * kGroupWarps,
                "a chunk's phi(k) in FP32, and a warp's scratch, fit the chunk buffers");
  static_assert(kGroupWarps * 16 * Group<C>::SCR * 4 <= 2 * 2 * PK,
                "the warps' scratch fits the chunk buffers");
  static_assert(BYTES <= kSmemLimit, "more shared memory than an sm_90 block may have");
};

// Outputs of the NeuS epilogue, all null when kNeus is false.
struct NeusOut {
  const float* z;      // (RN, SN)
  const float* rad;    // (RN, SN, 3)
  const float* inv_s;  // () on the device, clamped here to [1e-6, 1e6]
  float* weight;       // (RN, SN)
  float* rgb;          // (RN, 3)
  float* depth;        // (RN,)
  float* opacity;      // (RN,)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(kGroupThreads) : "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes of weights: from shared memory, or (kGlobal) read-only from
// global memory through the L1
template <bool kGlobal>
__device__ __forceinline__ uint4 ld_w4(const uint16_t* p) {
  if constexpr (kGlobal) return __ldg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const uint4*>(p);
}

// 16 bytes read once a tile from the L2, not allocated in the L1 (the wide
// layout's mlp1 fragments: they would evict the density weights)
__device__ __forceinline__ uint4 ldg_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// elu(x) + 1 without a branch (point_head_fast.cuh's phi_sel): the same
// values as common.cuh's phi; a NaN stays NaN
__device__ __forceinline__ float phi_sel(float x) {
  const float e = expf(x > 0.f ? 0.f : x);
  return x > 0.f ? x + 1.f : e;
}

// With UFO_RHF_PROBE defined (script/head_variants.py's rhf_probe), thread
// 0 of block 0 adds each phase's cycles, barrier waits included, to
// rhf_probe[i] and counts its rays in rhf_probe[15] and its phase-2 tiles in
// rhf_probe[14] (ufo_ray_head_fast_probe reads them).
#ifdef UFO_RHF_PROBE
static __device__ unsigned long long rhf_probe[16];
#define RHF_MARK(i)                                       \
  if (blockIdx.x == 0 && threadIdx.x == 0) {              \
    const unsigned long long now = clock64();             \
    rhf_probe[i] += now - probe_t0;                       \
    probe_t0 = now;                                       \
  }
#define RHF_COUNT(i) \
  if (blockIdx.x == 0 && threadIdx.x == 0) ++rhf_probe[i];
#else
#define RHF_MARK(i)
#define RHF_COUNT(i)
#endif

// A warp's 16 rows r0 .. r0 + 15 of the ray (C floats apart, yr 8-byte
// aligned) in the m16n8 C layout: x[j] holds rows g, g + 8 at columns
// 8j + 2t, 8j + 2t + 1; rows from SN on are zero.
template <int C>
__device__ __forceinline__ void load_rows(float (&x)[C / 8][4], const float* __restrict__ yr,
                                          int r0, int SN) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
  const float* pa = yr + (size_t)ra * C + 2 * t;
  const float* pb = yr + (size_t)rb * C + 2 * t;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const float2 a = ra < SN ? __ldg(reinterpret_cast<const float2*>(pa + 8 * j))
                             : make_float2(0.f, 0.f);
    const float2 b = rb < SN ? __ldg(reinterpret_cast<const float2*>(pb + 8 * j))
                             : make_float2(0.f, 0.f);
    x[j][0] = a.x;
    x[j][1] = a.y;
    x[j][2] = b.x;
    x[j][3] = b.y;
  }
}

// The m16k16 A fragments of a 16-row tile held in the m16n8 C layout: the
// k16 step s is C tiles 2s and 2s + 1, rounded to bf16 in pairs (a last odd
// tile pairs with zeros).
template <int NT, int KS>
__device__ __forceinline__ void to_frags(uint32_t (&a)[KS][4], const float (&x)[NT][4]) {
  static_assert(KS == (NT + 1) / 2, "two C tiles a k16 step");
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    a[s][0] = bf16x2_rn(x[2 * s][0], x[2 * s][1]);
    a[s][1] = bf16x2_rn(x[2 * s][2], x[2 * s][3]);
    if (2 * s + 1 < NT) {
      a[s][2] = bf16x2_rn(x[2 * s + 1][0], x[2 * s + 1][1]);
      a[s][3] = bf16x2_rn(x[2 * s + 1][2], x[2 * s + 1][3]);
    } else {
      a[s][2] = a[s][3] = 0u;
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// acc[j] += sum over the k16 steps s < KS of a[s] W^T, W's rows 8j .. 8j + 7
// and columns KOFF + 16s ..: W as bf16 rows KP apart in shared memory, wg =
// W + g * KP + 2t. K: the product's depth from KOFF; the half of a k16 step
// past it takes zeros (its A half is zero too).
template <int NT, int KS, int KP, int KOFF, int K>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const uint32_t (&a)[KS][4],
                                         const uint16_t* wg) {
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint16_t* p = wg + j * 8 * KP + KOFF + 16 * s;
      const uint32_t b0 = lds32(p);
      const uint32_t b1 = 16 * s + 8 < K ? lds32(p + 8) : 0u;
      tc::mma_bf16(acc[j], a[s], b0, b1);
    }
}

// LayerNorm (eps kLnEps, two-pass mean and variance) of 16 rows of C FP32
// features in shared memory (x, C apart), in place, by one warp with
// tc_gemm.cuh's layernorm_n's sums and roundings: a row's features c on
// lane c % 32, summed in c order on the lane, then over the warp by
// warp_sum. The 16 rows' warp sums are independent, so they overlap.
template <int C>
__device__ __forceinline__ void warp_layernorm(float* x, const float* scale, const float* bias) {
  constexpr int J = (C + 31) / 32;   // features per lane
  const int lane = threadIdx.x & 31;
  float v[16][J], mean[16], inv[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = lane + 32 * j;
      v[r][j] = c < C ? x[r * C + c] : 0.f;
      if (c < C) s += v[r][j];
    }
    mean[r] = s;
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) mean[r] = warp_sum(mean[r]) / C;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (lane + 32 * j < C) {
        const float d = v[r][j] - mean[r];
        q += d * d;
      }
    }
    inv[r] = q;
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) inv[r] = rsqrtf(warp_sum(inv[r]) / C + kLnEps);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    if (c >= C) continue;
    const float sc = scale[c], bi = bias[c];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float y = (v[r][j] - mean[r]) * inv[r] * sc + bi;
      x[r * C + c] = y;
    }
  }
}

// The m16n8 C layout of a 16-row FP32 tile in shared memory (C apart): x[j]
// holds rows g, g + 8 at columns 8j + 2t, 8j + 2t + 1; and back.
template <int C>
__device__ __forceinline__ void tile_to_smem(float* s, const float (&x)[C / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    *reinterpret_cast<float2*>(s + g * C + 8 * j + 2 * t) = make_float2(x[j][0], x[j][1]);
    *reinterpret_cast<float2*>(s + (g + 8) * C + 8 * j + 2 * t) = make_float2(x[j][2], x[j][3]);
  }
}

template <int C>
__device__ __forceinline__ void tile_from_smem(float (&x)[C / 8][4], const float* s) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < C / 8; ++j) {
    const float2 a = *reinterpret_cast<const float2*>(s + g * C + 8 * j + 2 * t);
    const float2 b = *reinterpret_cast<const float2*>(s + (g + 8) * C + 8 * j + 2 * t);
    x[j][0] = a.x;
    x[j][1] = a.y;
    x[j][2] = b.x;
    x[j][3] = b.y;
  }
}

// NeuS compositing of one ray by one warp (ray_head.cu's neus_epilogue,
// neus_render at cos_anneal_ratio 1), its srdf in global memory (written
// by the group before its barrier: read through the L2).
__device__ __forceinline__ void neus_ray(const float* sr, int SN, const float* __restrict__ z,
                                         const float* __restrict__ rad, float inv_s,
                                         float* __restrict__ weight, float* __restrict__ rgb,
                                         float* __restrict__ depth,
                                         float* __restrict__ opacity) {
  const int lane = threadIdx.x & 31;
  if (SN < 2) {   // no interval: empty weights, zero sums, as neus_render
    if (lane < 3) rgb[lane] = 0.f;
    else if (lane == 3) *depth = 0.f;
    else if (lane == 4) *opacity = 0.f;
    return;
  }
  float tr = 1.f;   // the transmittance before the step's first sample, in every lane
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < SN; s0 += 32) {
    const int s = s0 + lane;
    float a = 0.f, f = 1.f, zs = 0.f;
    if (s < SN) {
      // neus_render pads the SN - 1 intervals with their first and last
      // and averages neighbours: mid[s] = (iv[max(s-1, 0)] + iv[min(s,
      // SN-2)]) / 2
      const int j0 = s > 0 ? s - 1 : 0;
      const int j1 = s < SN - 2 ? s : SN - 2;
      zs = __ldg(z + s);
      const float mid = ((__ldg(z + j0 + 1) - __ldg(z + j0)) +
                         (__ldg(z + j1 + 1) - __ldg(z + j1))) * 0.5f;
      const float half = (-1.5f * mid) * 0.5f;   // iter_cos * interval * 0.5
      const float sd = __ldcg(sr + s);
      const float next_cdf = 1.f / (1.f + expf(-((sd + half) * inv_s)));
      const float prev_cdf = 1.f / (1.f + expf(-((sd - half) * inv_s)));
      a = fminf(fmaxf(((prev_cdf - next_cdf) + 1e-5f) / (prev_cdf + 1e-5f), 0.f), 1.f);
      f = (1.f - a) + 1e-7f;
    }
    // the exclusive product, serially in sample order (past SN a factor
    // of 1 leaves it as it is)
    float mine = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float fi = __shfl_sync(0xffffffffu, f, i);
      if (i == lane) mine = tr;
      tr *= fi;
    }
    if (s < SN) {
      const float w = a * mine;
      weight[s] = w;
      acc[0] += w * __ldg(rad + 3 * s);
      acc[1] += w * __ldg(rad + 3 * s + 1);
      acc[2] += w * __ldg(rad + 3 * s + 2);
      acc[3] += w * zs;
      acc[4] += w;
    }
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
    rgb[0] = acc[0];
    rgb[1] = acc[1];
    rgb[2] = acc[2];
    *depth = acc[3];
    *opacity = acc[4];
  }
}

template <int C, bool kNeus>
__global__ void __launch_bounds__(kThreads, 1) ray_head_fast_kernel(
    const float* __restrict__ y,         // (RN, SN, C)
    const uint16_t* __restrict__ wimg,   // the weight pack (Layout<C>)
    float* srdf,                         // (RN, SN)
    int RN, int SN, NeusOut nz) {
  using I = Layout<C>;
  using S = Smem<C>;
  constexpr int NT = C / 8, KS = (C + 15) / 16, KS2 = 2 * C / 16;
  constexpr int DK = C / NH, KC = I::KC, KC2 = I::KC2;
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  const uint16_t* Ws = reinterpret_cast<const uint16_t*>(sm);
  const float* F = reinterpret_cast<const float*>(sm + I::F32);
  auto* bar = reinterpret_cast<unsigned long long*>(sm + S::BAR);
  const int grp = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x - grp * kGroupThreads;   // thread of the group
  const int gw = gt >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  char* gs = sm + S::GROUPS + grp * S::GROUP;
  uint16_t* PK = reinterpret_cast<uint16_t*>(gs);     // kChunk x C: phi(k)
  uint16_t* PV = PK + S::PK;                           // kChunk x C: v
  float* R = reinterpret_cast<float*>(gs);             // kChunk x C: phi(k), FP32
  float* KV = reinterpret_cast<float*>(PV + S::PK);   // NH x DK x DK: the state
  float* KSB = KV + S::KV;                             // C: ksum
  // the warp's scratch in phase 2 (16 x SCR FP32)
  float* scr = R + gw * 16 * Group<C>::SCR;
  uint16_t* scr16 = reinterpret_cast<uint16_t*>(scr);
  // each thread's B-fragment row of the layers' matrices
  const uint16_t* wrow = Ws + g * KC + 2 * t;
  const uint16_t* w1row = nullptr;   // resident mlp1 (Img)
  if constexpr (!I::kWide) w1row = Ws + I::W1 + g * KC2 + 2 * t;
  // the density MLP's first two matrices: resident, or in the wide layout
  // in global memory
  const char* wpack = reinterpret_cast<const char*>(wimg);
  const uint16_t* wd0 = I::kWide ? reinterpret_cast<const uint16_t*>(wpack + I::DW0) : Ws + I::DW0;
  const uint16_t* wd1 = I::kWide ? reinterpret_cast<const uint16_t*>(wpack + I::DW1) : Ws + I::DW1;
  const uint16_t* w2row = Ws + I::W2 + g * KC2 + 2 * t;

  // the weight image, once per block: thread 0 starts the bulk copies,
  // every thread waits for them before its first product
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)), "r"((uint32_t)I::SHARED)
                 : "memory");
    for (int off = 0; off < I::SHARED; off += kPiece) {
      const uint32_t bytes = I::SHARED - off < kPiece ? I::SHARED - off : kPiece;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(sm + off)),
          "l"(wpack + off), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
    }
  }
  bool weights_in = false;
  auto wait_weights = [&]() {
    if (weights_in) return;
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
  };

  for (int ray = blockIdx.x * kGroups + grp; ray < RN; ray += gridDim.x * kGroups) {
#ifdef UFO_RHF_PROBE
    unsigned long long probe_t0 = clock64();
#endif
    RHF_COUNT(15);
    const float* yr = y + (size_t)ray * SN * C;
    // the state of the thread's feature d = gt (< C): kv[d][h DK + m] of
    // its head h, and the key sum of feature gt
    float kvs[DK];
#pragma unroll
    for (int m = 0; m < DK; ++m) kvs[m] = 0.f;
    float ks = 0.f;

    // phase 1: the state over the ray's samples, chunk by chunk; each sum
    // in sample order as ray_head.cu's kFast takes it (ksum of the FP32
    // phi(k), kv FP32 FMAs of the bf16 values), so that the two kernels'
    // outputs agree bit for bit
    const int chunks = (SN + kChunk - 1) / kChunk;
    for (int ch = 0; ch < chunks; ++ch) {
      const int c0 = ch * kChunk, rows = min(kChunk, SN - c0);
      const int r0 = c0 + 16 * gw;   // the warp's tile of the chunk
      const bool mine = 16 * gw < rows;
      const bool va = r0 + g < SN, vb = r0 + g + 8 < SN;
      uint32_t xa[KS][4];
      float kf[NT][4];   // phi(k) of the tile, the rows past SN zero
      if (mine) {
        {
          float x[NT][4];
          load_rows<C>(x, yr, r0, SN);
          to_frags(xa, x);
        }
        wait_weights();
        RHF_MARK(0);
        zero(kf);
        warp_mma<NT, KS, KC, 0, C>(kf, xa, wrow + I::QKV + C * KC);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          kf[j][0] = va ? phi_sel(kf[j][0]) : 0.f;
          kf[j][1] = va ? phi_sel(kf[j][1]) : 0.f;
          kf[j][2] = vb ? phi_sel(kf[j][2]) : 0.f;
          kf[j][3] = vb ? phi_sel(kf[j][3]) : 0.f;
        }
        tile_to_smem<C>(R + 16 * gw * C, kf);
      }
      group_sync(grp);
      // ksum: the FP32 sum of phi(k) over the samples, in order
      if (gt < C)
        for (int s = 0; s < rows; ++s) ks += R[s * C + gt];
      group_sync(grp);   // PK and PV overwrite R
      RHF_MARK(1);
      if (mine) {
        uint16_t* pk = PK + (16 * gw + g) * C + 2 * t;
        uint16_t* pv = PV + (16 * gw + g) * C + 2 * t;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          *reinterpret_cast<uint32_t*>(pk + 8 * j) = bf16x2_rn(kf[j][0], kf[j][1]);
          *reinterpret_cast<uint32_t*>(pk + 8 * C + 8 * j) = bf16x2_rn(kf[j][2], kf[j][3]);
        }
        float acc[NT][4];   // values (zero past SN: their rows are)
        zero(acc);
        warp_mma<NT, KS, KC, 0, C>(acc, xa, wrow + I::QKV + 2 * C * KC);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          *reinterpret_cast<uint32_t*>(pv + 8 * j) = bf16x2_rn(acc[j][0], acc[j][1]);
          *reinterpret_cast<uint32_t*>(pv + 8 * C + 8 * j) = bf16x2_rn(acc[j][2], acc[j][3]);
        }
      }
      group_sync(grp);
      RHF_MARK(2);
      // kv of the thread's feature: FP32 FMAs of the bf16 values, in
      // sample order
      if (gt < C) {
        const uint16_t* pk = PK + gt;
        const uint16_t* pv = PV + gt / DK * DK;
        for (int s = 0; s < rows; ++s) {
          const float k = __uint_as_float((uint32_t)pk[s * C] << 16);
#pragma unroll
          for (int m = 0; m < DK; ++m)
            kvs[m] = fmaf(k, __uint_as_float((uint32_t)pv[s * C + m] << 16), kvs[m]);
        }
      }
      RHF_MARK(3);
      if (ch + 1 < chunks) group_sync(grp);   // the next chunk overwrites R
    }
    // the state and ksum, rounded to bf16 (the products' operands)
    if (gt < C) {
#pragma unroll
      for (int m = 0; m < DK; ++m) KV[gt * DK + m] = bf16_round(kvs[m]);
      KSB[gt] = bf16_round(ks);
    }
    group_sync(grp);
    RHF_MARK(4);

    // phase 2: each warp its tiles of 16 samples, the products in registers
    // (each one's accumulators the next one's operand), the attention, the
    // LayerNorms and the density MLP through its scratch
    const int mts = (SN + 15) / 16;
    for (int mt = gw; mt < mts; mt += kGroupWarps) {
      RHF_COUNT(14);
      const int r0 = 16 * mt;
      float x[NT][4];   // the tokens, FP32: the residual
      load_rows<C>(x, yr, r0, SN);
      uint32_t xa[KS][4];
      to_frags(xa, x);
      wait_weights();
      RHF_MARK(5);
      // q -> phi, rounded to bf16, into the scratch
      float acc[NT][4];
      zero(acc);
      warp_mma<NT, KS, KC, 0, C>(acc, xa, wrow + I::QKV);
      uint16_t* qs = scr16;            // 16 x C: phi(q), bf16
      uint16_t* as = scr16 + 16 * C;   // 16 x C: the attention output, bf16
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        *reinterpret_cast<uint32_t*>(qs + g * C + 8 * j + 2 * t) =
            bf16x2_rn(phi_sel(acc[j][0]), phi_sel(acc[j][1]));
        *reinterpret_cast<uint32_t*>(qs + (g + 8) * C + 8 * j + 2 * t) =
            bf16x2_rn(phi_sel(acc[j][2]), phi_sel(acc[j][3]));
      }
      __syncwarp();
      // the linear attention per (sample, head), ray_head.cu's sums: den =
      // phi(q) . ksum + eps and num = phi(q) kv, FP32 FMAs in feature
      // order; a lane takes one head (its kv) for rows lane / 8 + 4i
      {
        const int h = lane & 7, rb = lane >> 3;
        float q[4][DK], den[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          den[i] = 0.f;
#pragma unroll
          for (int d = 0; d < DK; ++d) {
            q[i][d] = __uint_as_float((uint32_t)qs[(rb + 4 * i) * C + h * DK + d] << 16);
            den[i] = fmaf(q[i][d], KSB[h * DK + d], den[i]);
          }
          den[i] += kAttnEps;
        }
        const float* kv = KV + h * DK * DK;
#pragma unroll
        for (int m = 0; m < DK; ++m) {
          float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int d = 0; d < DK; ++d) {
            const float w = kv[d * DK + m];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = fmaf(q[i][d], w, a[i]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            as[(rb + 4 * i) * C + h * DK + m] = (uint16_t)(bf16x2_rn(a[i] / den[i], 0.f) & 0xffffu);
        }
      }
      __syncwarp();
      uint32_t aa[KS][4];   // the attention output: merge's A operand
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        aa[s][0] = lds32(as + g * C + 16 * s + 2 * t);
        aa[s][1] = lds32(as + (g + 8) * C + 16 * s + 2 * t);
        aa[s][2] = 16 * s + 8 < C ? lds32(as + g * C + 16 * s + 8 + 2 * t) : 0u;
        aa[s][3] = 16 * s + 8 < C ? lds32(as + (g + 8) * C + 16 * s + 8 + 2 * t) : 0u;
      }
      __syncwarp();
      RHF_MARK(6);
      // merge -> LayerNorm: the message
      zero(acc);
      warp_mma<NT, KS, KC, 0, C>(acc, aa, wrow + I::WM);
      tile_to_smem<C>(scr, acc);
      __syncwarp();
      warp_layernorm<C>(scr, F + I::N1S, F + I::N1B);
      __syncwarp();
      tile_from_smem<C>(acc, scr);
      // mlp1's operand [tokens | message], bf16: its k16 step s is C tiles
      // 2s, 2s + 1 of the two side by side (at C 88 step 5 takes the
      // tokens' last 8 columns and the message's first 8); the tokens'
      // tiles are q's A fragments' (the wide layout takes them from there,
      // its FP32 tokens read again for the residual)
      uint32_t ca[KS2][4];
#pragma unroll
      for (int s = 0; s < KS2; ++s)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * s + h, jx = j < NT ? j : 0, jm = j < NT ? 0 : j - NT;
          if constexpr (I::kWide) {
            ca[s][2 * h] = j < NT ? xa[jx >> 1][2 * (jx & 1)] : bf16x2_rn(acc[jm][0], acc[jm][1]);
            ca[s][2 * h + 1] =
                j < NT ? xa[jx >> 1][2 * (jx & 1) + 1] : bf16x2_rn(acc[jm][2], acc[jm][3]);
          } else {
            ca[s][2 * h] =
                j < NT ? bf16x2_rn(x[jx][0], x[jx][1]) : bf16x2_rn(acc[jm][0], acc[jm][1]);
            ca[s][2 * h + 1] =
                j < NT ? bf16x2_rn(x[jx][2], x[jx][3]) : bf16x2_rn(acc[jm][2], acc[jm][3]);
          }
        }
      RHF_MARK(7);
      // mlp1 over [tokens | message] (one product of depth 2C), 16 outputs
      // at a time, relu, rounded to bf16: one k16 step of mlp2's A operand
      float m2[NT][4];
      zero(m2);
      // the wide layout's mlp1 B fragments from the L2, step f of the
      // product (slice f / KS2, k16 step f % KS2) in slot f % AH: the first
      // AH steps' here, each next one's AH steps before its product
      constexpr int AH = KS2 % kW1Ahead == 0 ? KS2 / kW1Ahead : KS2;
      const uint4* w1f = reinterpret_cast<const uint4*>(wpack + w1f_offset<I>()) + lane;
      uint4 b[I::kWide ? AH : 1];
      if constexpr (I::kWide) {
#pragma unroll
        for (int f = 0; f < AH; ++f) b[f] = ldg_stream(w1f + 32 * f);
      }
#pragma unroll 1
      for (int c16 = 0; c16 < KS2; ++c16) {
        float h[2][4];
        zero(h);
        if constexpr (I::kWide) {
          // the products in warp_mma's order
          const uint4* slice = w1f + c16 * KS2 * 32;
#pragma unroll
          for (int s = 0; s < KS2; ++s) {
            const uint4 bs = b[s % AH];
            if (s + AH < KS2 || c16 + 1 < KS2) b[s % AH] = ldg_stream(slice + 32 * (s + AH));
            tc::mma_bf16(h[0], ca[s], bs.x, bs.y);
            tc::mma_bf16(h[1], ca[s], bs.z, bs.w);
          }
        } else {
          warp_mma<2, KS2, KC2, 0, 2 * C>(h, ca, w1row + 16 * c16 * KC2);
        }
        const uint32_t ha[1][4] = {{bf16x2_rn(fmaxf(h[0][0], 0.f), fmaxf(h[0][1], 0.f)),
                                    bf16x2_rn(fmaxf(h[0][2], 0.f), fmaxf(h[0][3], 0.f)),
                                    bf16x2_rn(fmaxf(h[1][0], 0.f), fmaxf(h[1][1], 0.f)),
                                    bf16x2_rn(fmaxf(h[1][2], 0.f), fmaxf(h[1][3], 0.f))}};
        warp_mma<NT, 1, KC2, 0, 16>(m2, ha, w2row + 16 * c16);
      }
      RHF_MARK(8);
      // LayerNorm, added to the tokens: the layer's output
      __syncwarp();
      tile_to_smem<C>(scr, m2);
      __syncwarp();
      warp_layernorm<C>(scr, F + I::N2S, F + I::N2B);
      __syncwarp();
      tile_from_smem<C>(m2, scr);
      // the wide layout reads the residual again (through the L1 or the
      // L2) rather than holding it in registers through mlp1
      if constexpr (I::kWide) load_rows<C>(x, yr, r0, SN);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m2[j][e] = x[j][e] + m2[j][e];
      // the density MLP C -> 32 -> 16 -> 1, ray_head.cu's sums (common.cuh
      // block_gemm: each output FP32 FMAs from its bias, k in order, of the
      // bf16 operands) through the scratch, its operands there as FP32
      // values, 8 k a step
      float* xs = scr;               // 16 x C: the layer's output, bf16-rounded
      float* hs = scr;               // then 16 x 32, and 16 x 16 after them
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m2[j][e] = bf16_round(m2[j][e]);
      tile_to_smem<C>(xs, m2);
      __syncwarp();
      {   // C -> 32: lane = output column, all 16 rows
        float o[16];
        const float b = F[I::DB0 + lane];
#pragma unroll
        for (int r = 0; r < 16; ++r) o[r] = b;
        const uint16_t* wc = wd0 + lane * KC;
#pragma unroll 1
        for (int k = 0; k < C; k += 8) {
          const uint4 wq = ld_w4<I::kWide>(wc + k);
          const float w[8] = {bf16_lo(wq.x), bf16_hi(wq.x), bf16_lo(wq.y), bf16_hi(wq.y),
                              bf16_lo(wq.z), bf16_hi(wq.z), bf16_lo(wq.w), bf16_hi(wq.w)};
#pragma unroll
          for (int r = 0; r < 16; ++r) {
            const float4 x0 = *reinterpret_cast<const float4*>(xs + r * C + k);
            const float4 x1 = *reinterpret_cast<const float4*>(xs + r * C + k + 4);
            o[r] = fmaf(x0.x, w[0], o[r]);
            o[r] = fmaf(x0.y, w[1], o[r]);
            o[r] = fmaf(x0.z, w[2], o[r]);
            o[r] = fmaf(x0.w, w[3], o[r]);
            o[r] = fmaf(x1.x, w[4], o[r]);
            o[r] = fmaf(x1.y, w[5], o[r]);
            o[r] = fmaf(x1.z, w[6], o[r]);
            o[r] = fmaf(x1.w, w[7], o[r]);
          }
        }
        __syncwarp();   // xs is read: the layer's output overwrites it
#pragma unroll
        for (int r = 0; r < 16; ++r) hs[r * D0 + lane] = bf16_round(fmaxf(o[r], 0.f));
      }
      __syncwarp();
      {   // 32 -> 16: lane = output column lane % 16, rows 8 (lane / 16) ..
        const int c = lane & 15, rh = (lane >> 4) * 8;
        float o[8];
        const float b = F[I::DB1 + c];
#pragma unroll
        for (int r = 0; r < 8; ++r) o[r] = b;
        const uint16_t* wc = wd1 + c * I::KD;
#pragma unroll
        for (int k = 0; k < D0; k += 8) {
          const uint4 wq = ld_w4<I::kWide>(wc + k);
          const float w[8] = {bf16_lo(wq.x), bf16_hi(wq.x), bf16_lo(wq.y), bf16_hi(wq.y),
                              bf16_lo(wq.z), bf16_hi(wq.z), bf16_lo(wq.w), bf16_hi(wq.w)};
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const float4 x0 = *reinterpret_cast<const float4*>(hs + (rh + r) * D0 + k);
            const float4 x1 = *reinterpret_cast<const float4*>(hs + (rh + r) * D0 + k + 4);
            o[r] = fmaf(x0.x, w[0], o[r]);
            o[r] = fmaf(x0.y, w[1], o[r]);
            o[r] = fmaf(x0.z, w[2], o[r]);
            o[r] = fmaf(x0.w, w[3], o[r]);
            o[r] = fmaf(x1.x, w[4], o[r]);
            o[r] = fmaf(x1.y, w[5], o[r]);
            o[r] = fmaf(x1.z, w[6], o[r]);
            o[r] = fmaf(x1.w, w[7], o[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < 8; ++r)
          hs[16 * D0 + (rh + r) * D1 + c] = bf16_round(fmaxf(o[r], 0.f));
      }
      __syncwarp();
      if (lane < 16 && r0 + lane < SN) {   // 16 -> 1: lane = row
        float o = F[I::DB2];
#pragma unroll
        for (int k = 0; k < D1; ++k) o = fmaf(hs[16 * D0 + lane * D1 + k], F[I::DW2 + k], o);
        srdf[(size_t)ray * SN + r0 + lane] = o;
      }
      __syncwarp();
      RHF_MARK(9);
    }
    // the ray's srdf is out and the scratch free: the next ray's phase 1
    // writes the chunk buffers
    group_sync(grp);
    if constexpr (kNeus) {
      if (gw == 0) {
        const float inv_s = fminf(fmaxf(__ldg(nz.inv_s), 1e-6f), 1e6f);
        neus_ray(srdf + (size_t)ray * SN, SN, nz.z + (size_t)ray * SN,
                 nz.rad + (size_t)ray * SN * 3, inv_s, nz.weight + (size_t)ray * SN,
                 nz.rgb + (size_t)ray * 3, nz.depth + ray, nz.opacity + ray);
      }
    }
    RHF_MARK(10);
  }
}

template <int C, bool kNeus>
int launch(const float* y, const float* w, float* srdf, int rn, int sn, NeusOut nz,
           cudaStream_t stream) {
  constexpr int smem = Smem<C>::BYTES;   // <= kSmemLimit (Smem's static_assert)
  if (rn <= 0) return 0;
  if (sn <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(ray_head_fast_kernel<C, kNeus>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int pairs = (rn + kGroups - 1) / kGroups;
  ray_head_fast_kernel<C, kNeus><<<pairs < sms ? pairs : sms, kThreads, smem, stream>>>(
      y, reinterpret_cast<const uint16_t*>(w), srdf, rn, sn, nz);
  return (int)cudaGetLastError();
}

// the instances of each width, one translation unit each
// (ray_head_fast.cu at C 88, ray_head_fast_<C>.cu at the others), and each
// unit's probe counters (UFO_RHF_PROBE; else cudaErrorNotSupported)
#define UFO_RHF_WIDTH(C)                                                                   \
  int launch_c##C(const float* y, const float* w, float* srdf, int rn, int sn, bool neus, \
                  NeusOut nz, cudaStream_t s);                                             \
  int probe_c##C(unsigned long long* out);
UFO_RHF_WIDTH(40)
UFO_RHF_WIDTH(48)
UFO_RHF_WIDTH(56)
UFO_RHF_WIDTH(64)
UFO_RHF_WIDTH(72)
UFO_RHF_WIDTH(80)
UFO_RHF_WIDTH(88)
UFO_RHF_WIDTH(96)
UFO_RHF_WIDTH(104)
UFO_RHF_WIDTH(112)
#undef UFO_RHF_WIDTH

// The instances of width C and the unit's probe read-out (a unit's own
// copy of rhf_probe)
#ifdef UFO_RHF_PROBE
#define UFO_RHF_PROBE_READ \
  return (int)cudaMemcpyFromSymbol(out, rhf_probe, sizeof(rhf_probe));
#else
#define UFO_RHF_PROBE_READ \
  (void)out;               \
  return (int)cudaErrorNotSupported;
#endif
#define UFO_RHF_INSTANCES(C)                                                                \
  int launch_c##C(const float* y, const float* w, float* srdf, int rn, int sn, bool neus, \
                  NeusOut nz, cudaStream_t s) {                                              \
    return neus ? launch<C, true>(y, w, srdf, rn, sn, nz, s)                               \
                : launch<C, false>(y, w, srdf, rn, sn, nz, s);                              \
  }                                                                                          \
  int probe_c##C(unsigned long long* out) { UFO_RHF_PROBE_READ }

}  // namespace rhf
}  // namespace ufo
