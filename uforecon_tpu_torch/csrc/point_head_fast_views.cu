// Fused per-point view head for Hopper (sm_90a), kernel_precision 'fast':
// the NV 6..11 instances (DTU's evaluation set 1 has 11 views), in a unit
// of their own beside point_head_fast.cu's NV 2..5.
//
// Replaces, at these view counts, the Pallas TPU kernel point_head_fused
// (body _kernel) of the JAX package's ops/fused_point_head.py in its
// 'fast' mode, as point_head_fast.cuh does below 6 views: the same
// function, token layout, weight pack (fused_point_head.fast_image) and
// block shape (persistent blocks of 512 threads, the image resident in
// shared memory by one TMA bulk load, a tile of 64 token rows). What
// differs is the sums: from 6 views on the layers and both small MLPs add
// their bf16 products by FP32 FMAs, k in order from zero (the plain
// version's sums on the CPU), since the tensor cores' own sums moved the
// fast render beyond the per-ray rule at these counts (0.937 of the rays
// at 11 views where 0.97 are needed). Every output equals that of the
// earlier design of these instances (point_head_fast.cuh's kernel with
// FMA-summed products) bit for bit: each sum is the same chain of fmaf in
// the same order; only which thread computes it changed.
//
// What bounds it on the H100: the FP32 FMA pipe (the layers' ~64,000
// multiply-adds a token row, 67 TFLOP/s; the bf16 tensor bound that
// chip_smoke prints is ~15x lower). The earlier instance reached ~32 % of
// that pipe (script/head_variants.py --views 11 phf,phf_probe, cycles a
// tile of 64 rows: 97,000 of 136,000 in the four products, 14,500 in the
// pre-similarity MLP on one warp, 9,000 in the radiance MLP on four): its
// products ran in the tensor cores' fragment layout, so every warp loaded
// and rounded all 64 activation rows at each k step and unpacked each
// bf16 weight for two rows, and warps 10..15 idled in the 80-wide ones.
//
// Design:
//   * Register-blocked FMA products (fma_gemm): a thread owns R rows by
//     CC columns (cols cg, cg + NCG, ...), keeps their R * CC sums in
//     registers, and at each step of 8 k loads each column's 8 bf16
//     weights once (one 16-byte load, conflict-free across the warp's
//     consecutive columns), unpacks them once for its R rows, and each
//     row's 8 activations as two 16-byte broadcasts. The tile shapes are
//     chosen per product by measurement (Shape).
//   * Activations are rounded to bf16 once a tile, not once a product: the
//     tokens X (read rounded by q | k | v and by mlp1) are copied rounded
//     into the buffer the product's output will take, and the product
//     keeps its outputs in registers over one more barrier before it
//     stores them (q | k | v from a copy in V; mlp1 from a copy in Q).
//   * Both small MLPs (pre-similarity, radiance) run across the block, a
//     thread an output, on the tile's real rows only (its TP points; the
//     radiance MLP on their view rows), with 16-byte loads.
//   * The attention reads k and v as float2 (DK even), the softmax runs a
//     thread per point and channel.
#include "point_head_fast.cuh"

namespace ufo {
namespace phf {

// The products' tile shapes (R rows by CC columns a thread): at tokens of
// 80 q | k | v (N 240) takes 8 x 4 on 480 threads, mlp1 (N 160) 8 x 4 on
// 320, merge and mlp2 (N 80) 8 x 2 on 320; at tokens of 72 (N 216, 144,
// 72) 8 x 4, 8 x 4 and 8 x 2 on 432, 288 and 288.
template <int N>
struct Shape {
  static constexpr int R = 8;
  static constexpr int CC = N % 4 == 0 && N >= 144 ? 4 : 2;
};

// sum_k bf16(a[k]) * w[k], k in order from zero: a FP32 (16-byte aligned),
// w bf16 (16-byte aligned), K compile-time; the plain version's sum on the
// CPU.
template <int K>
__device__ __forceinline__ float fma_dot(const float* a, const uint16_t* w) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k + 8 <= K; k += 8) {
    const float4 x0 = *reinterpret_cast<const float4*>(a + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a + k + 4);
    const uint4 u = *reinterpret_cast<const uint4*>(w + k);
    acc = fmaf(bf16_round(x0.x), bf16_lo(u.x), acc);
    acc = fmaf(bf16_round(x0.y), bf16_hi(u.x), acc);
    acc = fmaf(bf16_round(x0.z), bf16_lo(u.y), acc);
    acc = fmaf(bf16_round(x0.w), bf16_hi(u.y), acc);
    acc = fmaf(bf16_round(x1.x), bf16_lo(u.z), acc);
    acc = fmaf(bf16_round(x1.y), bf16_hi(u.z), acc);
    acc = fmaf(bf16_round(x1.z), bf16_lo(u.w), acc);
    acc = fmaf(bf16_round(x1.w), bf16_hi(u.w), acc);
  }
#pragma unroll
  for (int k = K / 8 * 8; k < K; ++k)
    acc = fmaf(bf16_round(a[k]), __uint_as_float((uint32_t)w[k] << 16), acc);
  return acc;
}

// A small dense layer across the block: out(m, c, act(b[c] + sum_k
// bf16(a_m[k]) W[c, k])) for m < M, c < N, a_m = a + row(m) * lda, W as
// its (N, KW) bf16 rows; a thread an output.
template <int K, int KW, int N, typename Row, typename Out>
__device__ __forceinline__ void block_layer(const float* a, int lda, Row row, int M,
                                            const uint16_t* w, const float* b, bool relu,
                                            Out out) {
  for (int i = threadIdx.x; i < M * N; i += kThreads) {
    const int m = i / N, c = i - (i / N) * N;
    float acc = fma_dot<K>(a + row(m) * lda, w + c * KW) + b[c];
    out(m, c, relu ? fmaxf(acc, 0.f) : acc);
  }
}

// acc[i][j] += a[i, k] W[cols j, kw + k] for k < K in order, a_i = a +
// (r0 + i) * lda, the columns cg + NCG * j; one 16-byte load of 8 bf16
// weights a column, unpacked once for the R rows, and two 16-byte
// broadcasts of 8 activations a row at each step of 8 k.
template <int R, int CC, int NCG, int KP, int K>
__device__ __forceinline__ void fma_steps(float (&acc)[R][CC], const float* a, int lda,
                                          const uint16_t* wt, int kw, int r0, int cg) {
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    float w[CC][8];
#pragma unroll
    for (int j = 0; j < CC; ++j) {
      const uint4 u = *reinterpret_cast<const uint4*>(wt + (cg + NCG * j) * KP + kw + k);
      w[j][0] = bf16_lo(u.x);
      w[j][1] = bf16_hi(u.x);
      w[j][2] = bf16_lo(u.y);
      w[j][3] = bf16_hi(u.y);
      w[j][4] = bf16_lo(u.z);
      w[j][5] = bf16_hi(u.z);
      w[j][6] = bf16_lo(u.w);
      w[j][7] = bf16_hi(u.w);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float* ar = a + (r0 + i) * lda + k;
      const float4 x0 = *reinterpret_cast<const float4*>(ar);
      const float4 x1 = *reinterpret_cast<const float4*>(ar + 4);
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < CC; ++j)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i][j] = fmaf(x[q], w[j][q], acc[i][j]);
    }
  }
}

// out[r, c] = sum_k a[r, k] W[c, k] over the tile's kRows rows and N
// columns, a = [a1 (K1 columns, stride LDA1) | a2 (K2, LDA2)], bf16 values
// held as FP32 in shared memory (16-byte aligned rows), W as its (N, KP)
// bf16 rows in shared memory. Each sum is FP32 FMAs, k in order from zero.
// Thread t < NRB * NCG owns rows R * (t / NCG) .. + R - 1 and columns
// t % NCG + NCG * j, j < CC. With kDefer the block syncs between the
// products and the stores (the outputs may then overwrite a1 or a2);
// epi(row, col, v) stores one output.
template <int N, int KP, int K1, int LDA1, int K2, int LDA2, bool kDefer, typename Epi>
__device__ __forceinline__ void fma_gemm(const float* a1, const float* a2, const uint16_t* wt,
                                         Epi epi) {
  constexpr int R = Shape<N>::R, CC = Shape<N>::CC;
  constexpr int NCG = N / CC, NRB = kRows / R;
  static_assert(N % CC == 0 && kRows % R == 0 && NRB * NCG <= kThreads,
                "one item a thread, whole column groups");
  static_assert(K1 % 8 == 0 && K2 % 8 == 0 && LDA1 % 4 == 0 && LDA2 % 4 == 0 && KP % 8 == 0,
                "16-byte loads of 8 k");
  const int t = threadIdx.x;
  const bool mine = t < NRB * NCG;
  const int rb = mine ? t / NCG : 0, cg = t - rb * NCG;
  float acc[R][CC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CC; ++j) acc[i][j] = 0.f;
  if (mine) {
    fma_steps<R, CC, NCG, KP, K1>(acc, a1, LDA1, wt, 0, rb * R, cg);
    if constexpr (K2 > 0) fma_steps<R, CC, NCG, KP, K2>(acc, a2, LDA2, wt, K1, rb * R, cg);
  }
  if constexpr (kDefer) group_sync<kThreads>(0);
  if (mine) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < CC; ++j) epi(rb * R + i, cg + NCG * j, acc[i][j]);
  }
}

template <int CV, int NV>
__global__ void __launch_bounds__(kThreads, 1) point_head_fma_kernel(
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
  constexpr int L = NV + 1, GR = kRows, TP = GR / L;
  static_assert(NV >= 6 && NV <= ph::kMaxViews && TP >= 1, "the views instances");
  static_assert(LD2 <= 2 * LD && TP * NV * (R1 + R2) + GR <= 2 * GR * LD,
                "the buffers hold what the kernel puts there");
  static_assert(I::SW0 % 8 == 0 && I::SW1 % 8 == 0 && I::SW2 % 8 == 0 && I::RW0 % 8 == 0 &&
                    I::RW1 % 8 == 0 && I::RW2 % 8 == 0 && I::WM % 8 == 0 && I::W1 % 8 == 0 &&
                    I::W2 % 8 == 0,
                "16-byte aligned weight rows");
  extern __shared__ float4 smem4[];
  uint16_t* Ws = reinterpret_cast<uint16_t*>(smem4);
  const float* F = reinterpret_cast<const float*>(reinterpret_cast<char*>(smem4) + I::F32);
  const float* tok = reinterpret_cast<const float*>(reinterpret_cast<const char*>(wimg) +
                                                    I::BYTES);
  auto* bar = reinterpret_cast<unsigned long long*>(reinterpret_cast<char*>(smem4) + I::BYTES);
  const int gt = threadIdx.x;
  float* X = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + I::BYTES + 16);
  float* Qb = X + GR * LD;           // q | k | v, one after another
  float* Kb = Qb + GR * LD;
  float* Vb = Kb + GR * LD;

  // the weight image, once per block (point_head_fast.cuh)
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
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
#ifdef UFO_PHF_PROBE
    unsigned long long probe_t0 = clock64();
#endif
    const int p0 = tile * TP;
    const bool full = p0 + TP <= P;
    // 1. inputs, as point_head_fast.cuh: image and volume features into
    //    the view rows of X, dir_rel and mask into their padding columns,
    //    rgb into V's; raw cosines and depth distances to scratch; the
    //    view-token rows; the padding rows zero
    float* s_in = Qb;               // TP x SIN
    float* s_h1 = s_in + 16 * SIN;  // TP x SH
    float* s_h2 = s_h1 + 16 * SH;   // TP x SH
    float* dds = Kb;                // NV x TP
    if (full) {
      for (int i = gt; i < NV * TP * (CI / 4); i += kThreads) {
        const int v = i / (TP * (CI / 4)), p = (i / (CI / 4)) % TP, c4 = i % (CI / 4);
        tc::cp_async16(X + (p * L + 1 + v) * LD + 4 * c4,
                       img + ((size_t)v * P + p0 + p) * CI + 4 * c4);
      }
      for (int i = gt; i < NV * TP * (CV / 4); i += kThreads) {
        const int v = i / (TP * (CV / 4)), p = (i / (CV / 4)) % TP, c4 = i % (CV / 4);
        tc::cp_async16(X + (p * L + 1 + v) * LD + CI + 4 * c4,
                       vol + (size_t)(p0 + p) * CV + 4 * c4);
      }
    } else {
      for (int i = gt; i < NV * TP * (CI + CV); i += kThreads) {
        const int v = i / (TP * (CI + CV)), p = (i / (CI + CV)) % TP, c = i % (CI + CV);
        const int gp = p0 + p;
        float val = 0.f;
        if (gp < P)
          val = c < CI ? img[((size_t)v * P + gp) * CI + c] : vol[(size_t)gp * CV + c - CI];
        X[(p * L + 1 + v) * LD + c] = val;
      }
    }
    tc::cp_async_commit();
    for (int i = gt; i < TP * SIN; i += kThreads) {
      const int gp = p0 + i / SIN;
      s_in[i] = gp < P ? __ldg(sim + (size_t)gp * SIN + i % SIN) : 0.f;
    }
    for (int i = gt; i < NV * TP; i += kThreads) {
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
    for (int i = gt; i < TP * LD; i += kThreads)
      X[(i / LD) * L * LD + i % LD] = i % LD < C ? __ldg(tok + i % LD) : 0.f;
    for (int i = gt; i < (GR - TP * L) * LD; i += kThreads) X[TP * L * LD + i] = 0.f;
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
    group_sync<kThreads>(0);
    PHF_MARK(0);

    // 2. the pre-similarity MLP over the tile's points, a thread an
    //    output, its last layer's 16 outputs into each view row of the
    //    point (zero past P); beside its first layer, the other threads
    //    take each view row's NeRF PE of its depth distance
    auto rows = [](int m) { return m; };
    if (gt < TP * SH) {
      block_layer<SIN, I::KS0, SH>(s_in, SIN, rows, TP, Ws + I::SW0, F + I::SB0, true,
                                   [&](int m, int c, float y) { s_h1[m * SH + c] = y; });
    } else {
      for (int i = gt - TP * SH; i < NV * TP * PE; i += kThreads - TP * SH) {
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
    group_sync<kThreads>(0);
    block_layer<SH, I::KS, SH>(s_h1, SH, rows, TP, Ws + I::SW1, F + I::SB1, true,
                               [&](int m, int c, float y) { s_h2[m * SH + c] = y; });
    group_sync<kThreads>(0);
    block_layer<SH, I::KS, SOUT>(s_h2, SH, rows, TP, Ws + I::SW2, F + I::SB2, false,
                                 [&](int m, int c, float y) {
                                   const float val = p0 + m < P ? y : 0.f;
#pragma unroll
                                   for (int v = 0; v < NV; ++v)
                                     X[(m * L + 1 + v) * LD + CI + CV + c] = val;
                                 });
    tc::cp_async_wait<0>();
    group_sync<kThreads>(0);
    PHF_MARK(1);

    // 3. the tokens rounded to bf16 into V, then q | k | v in one product
    //    from them, phi of q and k in its epilogue, the stores after a
    //    barrier (v overwrites the rounded copy; V's padding columns keep
    //    the rgb)
    for (int i = gt; i < GR * (C / 4); i += kThreads) {
      const int r = i / (C / 4), c4 = i % (C / 4);
      const float4 x = *reinterpret_cast<const float4*>(X + r * LD + 4 * c4);
      *reinterpret_cast<float4*>(Vb + r * LD + 4 * c4) =
          make_float4(bf16_round(x.x), bf16_round(x.y), bf16_round(x.z), bf16_round(x.w));
    }
    group_sync<kThreads>(0);
    fma_gemm<3 * C, I::KC, C, LD, 0, LD, true>(Vb, nullptr, Ws + I::QKV,
                                               [&](int r, int c, float v) {
                                                 const int which = c / C;
                                                 if (which < 2) v = phi_sel(v);
                                                 Qb[which * GR * LD + r * LD + c - which * C] = v;
                                               });
    group_sync<kThreads>(0);
    PHF_MARK(2);

    // 4. linear attention among each point's L tokens, per head, in
    //    point_head_fast.cuh's order; the thread of (row, head) overwrites
    //    its q with the output, rounded to bf16 (merge's operand only)
    for (int it = gt; it < TP * L * NH; it += kThreads) {
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
        float kv[DK], vv[DK];
        if constexpr (DK % 2 == 0) {
#pragma unroll
          for (int d = 0; d < DK; d += 2) {
            const float2 k2 = *reinterpret_cast<const float2*>(ks + d);
            const float2 v2 = *reinterpret_cast<const float2*>(vs + d);
            kv[d] = k2.x;
            kv[d + 1] = k2.y;
            vv[d] = v2.x;
            vv[d + 1] = v2.y;
          }
        } else {
#pragma unroll
          for (int d = 0; d < DK; ++d) {
            kv[d] = ks[d];
            vv[d] = vs[d];
          }
        }
        float sc = 0.f;
#pragma unroll
        for (int d = 0; d < DK; ++d) sc = fmaf(q[d], kv[d], sc);
        den += sc;
#pragma unroll
        for (int d = 0; d < DK; ++d) acc[d] = fmaf(sc, vv[d], acc[d]);
      }
      den += kAttnEps;
#pragma unroll
      for (int d = 0; d < DK; ++d) Qb[r * LD + h * DK + d] = bf16_round(acc[d] / den);
    }
    group_sync<kThreads>(0);
    PHF_MARK(3);

    // 5. merge -> V (v is dead; its padding columns keep the rgb); then
    //    its LayerNorm, stored bf16-rounded (mlp1's operand only), and
    //    beside it the tokens rounded into Q (the attention output is dead)
    fma_gemm<C, I::KC, C, LD, 0, LD, false>(Qb, nullptr, Ws + I::WM,
                                            [&](int r, int c, float v) { Vb[r * LD + c] = v; });
    group_sync<kThreads>(0);
    PHF_MARK(4);
    group_layernorm<C, kThreads>(Vb, LD, GR, gt, F + I::N1S, F + I::N1B,
                                   [&](int r, int c, float y) { Vb[r * LD + c] = bf16_round(y); });
    for (int i = gt; i < GR * (C / 4); i += kThreads) {
      const int r = i / (C / 4), c4 = i % (C / 4);
      const float4 x = *reinterpret_cast<const float4*>(X + r * LD + 4 * c4);
      *reinterpret_cast<float4*>(Qb + r * LD + 4 * c4) =
          make_float4(bf16_round(x.x), bf16_round(x.y), bf16_round(x.z), bf16_round(x.w));
    }
    group_sync<kThreads>(0);
    PHF_MARK(5);
    // 6. mlp1 over [tokens | message] -> Q|K (GR x LD2), relu, stored
    //    bf16-rounded (mlp2's operand only) after a barrier
    fma_gemm<C2, I::KC2, C, LD, C, LD, true>(Qb, Vb, Ws + I::W1, [&](int r, int c, float v) {
      Qb[r * LD2 + c] = bf16_round(fmaxf(v, 0.f));
    });
    group_sync<kThreads>(0);
    PHF_MARK(6);
    // 7. mlp2 -> V, its LayerNorm added into X (the residual)
    fma_gemm<C, I::KC2, C2, LD2, 0, LD2, false>(Qb, nullptr, Ws + I::W2,
                                                [&](int r, int c, float v) { Vb[r * LD + c] = v; });
    group_sync<kThreads>(0);
    PHF_MARK(7);
    group_layernorm<C, kThreads>(Vb, LD, GR, gt, F + I::N2S, F + I::N2B,
                                   [&](int r, int c, float y) { X[r * LD + c] += y; });
    group_sync<kThreads>(0);
    PHF_MARK(8);

    // 8. the view-token output; the radiance MLP over the view rows of the
    //    tile's points ([token out | dir_rel], X's first CR columns), a
    //    thread an output, its hidden layers in Q, its logits in K
    for (int i = gt; i < TP * C; i += kThreads) {
      const int p = i / C, c = i - (i / C) * C;
      if (p0 + p < P) token_out[(size_t)(p0 + p) * C + c] = X[p * L * LD + c];
    }
    float* h1 = Qb;                 // TP * NV x R1
    float* h2 = h1 + TP * NV * R1;  // TP * NV x R2
    float* lg = Kb;                 // GR: a logit a token row
    auto view_row = [](int m) { return (m / NV) * L + 1 + m % NV; };
    block_layer<CR, I::KR0, R1>(X, LD, view_row, TP * NV, Ws + I::RW0, F + I::RB0, true,
                                [&](int m, int c, float y) { h1[m * R1 + c] = y; });
    group_sync<kThreads>(0);
    block_layer<R1, I::KR1, R2>(h1, R1, rows, TP * NV, Ws + I::RW1, F + I::RB1, true,
                                [&](int m, int c, float y) { h2[m * R2 + c] = y; });
    group_sync<kThreads>(0);
    block_layer<R2, I::KR2, 1>(h2, R2, rows, TP * NV, Ws + I::RW2, F + I::RB2, false,
                               [&](int m, int, float y) { lg[view_row(m)] = y; });
    group_sync<kThreads>(0);
    PHF_MARK(9);

    // 9. the masked softmax over each point's views and the rgb blend, in
    //    point_head.cuh's order, a thread a point and channel (each takes
    //    the point's logits, max and sum itself); a point masked in every
    //    view gets uniform weights (the mean rgb), as the JAX softmax does
    for (int i = gt; i < TP * 3; i += kThreads) {
      const int p = i / 3, ch = i - (i / 3) * 3, gp = p0 + p;
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
      float acc = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        acc = fmaf(Vb[(p * L + 1 + v) * LD + C + ch], logit[v] / sum, acc);
      rad_out[(size_t)gp * 3 + ch] = acc;
    }
    // the next tile overwrites the buffers
    group_sync<kThreads>(0);
    PHF_MARK(10);
  }
}

template <int CV, int NV>
int launch_fma(const float* img, const float* vol, const float* sim, const float* dd,
               const float* dir, const float* rgb, const float* mask, const float* w,
               float* token, float* rad, int p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CV>();
  static_assert(smem <= 232448, "more shared memory than an sm_90 block may have");
  cudaError_t e = cudaFuncSetAttribute(point_head_fma_kernel<CV, NV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int tiles = (p + kRows / (NV + 1) - 1) / (kRows / (NV + 1));
  point_head_fma_kernel<CV, NV><<<tiles < sms ? tiles : sms, kThreads, smem, stream>>>(
      img, vol, sim, dd, dir, rgb, mask, reinterpret_cast<const uint16_t*>(w), token, rad, p);
  return (int)cudaGetLastError();
}

}  // namespace phf

namespace ph {

template <int CV>
int launch_fast_views(UFO_PH_ARGS, int nv, int p, cudaStream_t s) {
  static_assert(kMaxViews == 11, "the cases below run to kMaxViews");
#define UFO_PHV_CASE(NV) \
  case NV:               \
    return phf::launch_fma<CV, NV>(img, vol, sim, dd, dir, rgb, mask, w, token, rad, p, s);
  switch (nv) {
    UFO_PHV_CASE(6)
    UFO_PHV_CASE(7)
    UFO_PHV_CASE(8)
    UFO_PHV_CASE(9)
    UFO_PHV_CASE(10)
    UFO_PHV_CASE(11)
    default: return (int)cudaErrorInvalidValue;
  }
#undef UFO_PHV_CASE
}

template int launch_fast_views<24>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);
template int launch_fast_views<16>(UFO_PH_ARGS, int nv, int p, cudaStream_t s);

}  // namespace ph
}  // namespace ufo

#ifdef UFO_PHF_PROBE
// the probe's per-phase cycles and tile count (point_head_fast.cuh), for
// the NV 6..11 instances
extern "C" int ufo_point_head_fast_views_probe(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, ufo::phf::phf_probe, sizeof(ufo::phf::phf_probe));
}
#endif
