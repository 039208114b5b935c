// Fused per-point view head for Hopper (sm_90a) at any view count above
// the compiled-in ones (NV > kMaxViews = 11), in both precisions.
//
// The JAX kernel (ops/fused_point_head.py _kernel) takes any count. Past
// 11 views a point's NV + 1 token rows outgrow the resident tile of
// point_head.cuh (144 rows), and at 143 views or more one point's rows no
// longer fit a block's shared memory at all. So this kernel streams the
// token rows through a chunk of kStreamRows rows in shared memory, with the
// count a runtime value, in two passes over a tile of points:
//   1. each chunk's tokens are built and their keys phi(x Wk) and values
//      x Wv go to global scratch (the block's own slice, in the L2);
//   2. each chunk's tokens are built again; q, the linear attention over
//      the point's L keys and values from scratch (q.k per token, then
//      over the tokens in order, as point_head.cuh step 5 and the plain
//      version take them), merge, LayerNorm, mlp1 over [token | message],
//      mlp2, the residual, the view-token output, and the radiance MLP's
//      logits, which go to scratch too.
// A tile ends with the masked softmax over its points' logits (masked at
// -1e9, as JAX) and the rgb blend, in the resident kernel's order. The
// layers are tc_gemm.cuh's: 3xTF32, or in 'fast' the bf16 products added
// by FP32 FMAs, k in order (kFmaSum), as the resident fast kernel does
// from 6 views on. A tile holds min(16, kStreamRows / (NV + 1)) points,
// at least one: 9 at NV 12, 2 at NV 49, one (its rows in several chunks)
// from NV 64 on. Blocks are persistent, one an SM (194,560 bytes of
// shared memory at tokens of 80), walking over the tiles, so the scratch
// is bounded by the SM count, not by P.
//
// What bounds it: the same arithmetic as the resident kernel plus the
// second pass's rebuilt tokens and the keys and values read from the L2
// (each query reads its point's L keys and values: L^2 2C floats a point),
// one block an SM with its syncs unhidden. It is the rare path (custom
// captures with more than 10 sources, or training at --train_n_view above
// 11); its time is in PERF.md.
#include "point_head.cuh"

namespace ufo {
namespace ph {

constexpr int kStreamRows = 128;   // token rows of a chunk: 8 m16 tiles

// points a tile holds at NV views
__host__ __device__ inline int stream_points(int nv) {
  const int pts = kStreamRows / (nv + 1);
  return pts < 1 ? 1 : (pts > TP_MAX ? TP_MAX : pts);
}

// chunks a tile's token rows take
__host__ __device__ inline int stream_chunks(int nv) {
  return (stream_points(nv) * (nv + 1) + kStreamRows - 1) / kStreamRows;
}

// floats of scratch a block takes: keys and values of its tile's chunks,
// then the tile's logits
__host__ __device__ inline long long stream_block_floats(int c, int nv) {
  return (long long)stream_chunks(nv) * kStreamRows * 2 * c +
         (long long)stream_points(nv) * nv;
}

template <int CV>
constexpr size_t stream_smem_bytes() {
  using D = Dims<CV>;
  return sizeof(float) * ((size_t)kStreamRows * 4 * D::LD +
                          tc::ring_floats(kStages, D::C2) + TP_MAX * SOUT);
}

template <int CV, bool kFast>
__global__ void __launch_bounds__(kPointThreads, 1) point_head_stream_kernel(
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
    float* __restrict__ scratch,      // gridDim.x x stream_block_floats(C, NV)
    int NV, int P) {
  using D = Dims<CV>;
  constexpr int C = D::C, DK = D::DK, C2 = D::C2, CR = D::CR, LD = D::LD, LD2 = D::LD2;
  constexpr int R = kStreamRows, MT = R / 16;
  constexpr int NT_C = tc::col_tiles(kPointThreads / 32, MT, C);
  constexpr int NT_C2 = tc::col_tiles(kPointThreads / 32, MT, C2);
  static_assert(MT <= kPointThreads / 32, "a row tile per warp");
  static_assert(R * CR <= 2 * R * LD, "radiance input must fit Q|V");
  static_assert(16 * (SIN + 2 * SH) <= R * LD, "similarity scratch must fit V");
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // R x LD  tokens, later the layer output
  float* Kb = X + R * LD;             // R x LD  message, mlp2 out, radiance scratch
  float* Qb = Kb + R * LD;            // R x LD  queries -> attention output
  float* Vb = Qb + R * LD;            // R x LD  Qb|Vb hold mlp1's R x LD2
  float* ring = Vb + R * LD;          // weight slots
  float* s16 = ring + tc::ring_floats(kStages, C2);   // TP_MAX x SOUT
  const int tid = threadIdx.x;
  const int L = NV + 1;
  const int TP = stream_points(NV);
  const int rows = TP * L;
  const int nchunks = stream_chunks(NV);
  float* Ks = scratch + (size_t)blockIdx.x * stream_block_floats(C, NV);
  float* Vs = Ks + (size_t)nchunks * R * C;
  float* Ls = Vs + (size_t)nchunks * R * C;   // TP x NV logits
  const int tiles = (P + TP - 1) / TP;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * TP;
    const int TP4 = (TP + 3) / 4 * 4;   // block_linear takes rows in fours

    // pre-similarity MLP on the tile's points (scratch in Vb)
    float* s_in = Vb;
    float* s_h1 = s_in + 16 * SIN;
    float* s_h2 = s_h1 + 16 * SH;
    for (int i = tid; i < TP4 * SIN; i += blockDim.x) {
      const int p = i / SIN, gp = p0 + p;
      s_in[i] = p < TP && gp < P ? sim[(size_t)gp * SIN + i % SIN] : 0.f;
    }
    __syncthreads();
    block_linear<4, kFast>(s_in, SIN, SIN, W + D::O_SW0, W + D::O_SB0, s_h1, SH, TP4, SH,
                                  true);
    __syncthreads();
    block_linear<4, kFast>(s_h1, SH, SH, W + D::O_SW1, W + D::O_SB1, s_h2, SH, TP4, SH,
                                  true);
    __syncthreads();
    block_linear<4, kFast>(s_h2, SH, SH, W + D::O_SW2, W + D::O_SB2, s16, SOUT, TP4,
                                  SOUT, false);
    __syncthreads();

    for (int pass = 0; pass < 2; ++pass) {
      for (int ch = 0; ch < nchunks; ++ch) {
        const int r0 = ch * R;                         // the chunk's first tile row
        const int nr = rows - r0 < R ? rows - r0 : R;  // its real rows
        const int mt = (nr + 15) / 16;                 // m16 tiles that hold them
        // the chunk's tokens: row rg = p L + l of the tile is the view
        // token (l = 0) or view l - 1's [img | vol | sim16 | pe]; zero past
        // the tile's rows and for points past P
        for (int i = tid; i < mt * 16 * C; i += blockDim.x) {
          const int r = i / C, c = i - (i / C) * C, rg = r0 + r;
          const int p = rg / L, l = rg - (rg / L) * L, gp = p0 + p;
          float val = 0.f;
          if (rg < rows) {
            if (l == 0) {
              val = __ldg(W + D::O_TOK + c);
            } else if (gp < P) {
              const int v = l - 1;
              if (c < CI) {
                val = __ldg(img + ((size_t)v * P + gp) * CI + c);
              } else if (c < CI + CV) {
                val = __ldg(vol + (size_t)gp * CV + c - CI);
              } else if (c < CI + CV + SOUT) {
                val = s16[p * SOUT + c - CI - CV];
              } else {
                const int k = c - CI - CV - SOUT;
                const float f = ldexpf(kPi, k >> 1);
                const float ph = (k & 1) ? 0.5f * kPi : 0.f;
                // the product and the sum rounded apart, as the plain
                // version's x * f + ph
                val = sinf(__fadd_rn(__fmul_rn(__ldg(dd + (size_t)v * P + gp), f), ph));
              }
            }
          }
          X[r * LD + c] = val;
        }
        __syncthreads();

        if (pass == 0) {
          // keys and values of the chunk's rows into the block's scratch
          tc::gemm<kStages, NT_C, kFast, kFast>(X, LD, C, nullptr, 0, 0, W + D::O_WK, ring,
                                                Ks + (size_t)r0 * C, C, mt, C, tc::kPhi);
          tc::gemm<kStages, NT_C, kFast, kFast>(X, LD, C, nullptr, 0, 0, W + D::O_WV, ring,
                                                Vs + (size_t)r0 * C, C, mt, C, tc::kNone);
          continue;
        }

        tc::gemm<kStages, NT_C, kFast, kFast>(X, LD, C, nullptr, 0, 0, W + D::O_WQ, ring, Qb,
                                              LD, mt, C, tc::kPhi);
        // linear attention of each row over its point's L tokens, per
        // head; the thread of (row, head) overwrites its q
        for (int t = tid; t < nr * NH; t += blockDim.x) {
          const int r = t / NH, h = t - (t / NH) * NH;
          const int base = ((r0 + r) / L) * L;
          float q[DK], acc[DK];
#pragma unroll
          for (int d = 0; d < DK; ++d) {
            q[d] = Qb[r * LD + h * DK + d];
            acc[d] = 0.f;
          }
          float den = 0.f;
          for (int s = 0; s < L; ++s) {
            const float* ks = Ks + (size_t)(base + s) * C + h * DK;
            const float* vs = Vs + (size_t)(base + s) * C + h * DK;
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

        // merge + LayerNorm -> Kb; mlp1 over [tokens | message] -> Qb|Vb;
        // mlp2 -> Kb, its LayerNorm added into X (the residual)
        tc::gemm<kStages, NT_C, kFast, kFast>(Qb, LD, C, nullptr, 0, 0, W + D::O_WM, ring, Kb,
                                              LD, mt, C, tc::kNone);
        tc::layernorm<C>(Kb, LD, mt * 16, W + D::O_N1S, W + D::O_N1B);
        tc::gemm<kStages, NT_C2, kFast, kFast>(X, LD, C, Kb, LD, C, W + D::O_W1, ring, Qb, LD2,
                                               mt, C2, tc::kRelu);
        tc::gemm<kStages, NT_C, kFast, kFast>(Qb, LD2, C2, nullptr, 0, 0, W + D::O_W2, ring,
                                              Kb, LD, mt, C, tc::kNone);
        tc::layernorm<C>(Kb, LD, mt * 16, W + D::O_N2S, W + D::O_N2B, X, LD);

        // the view-token rows' output; every row's radiance input
        // [token out | dir] (zero for the view-token rows and past P)
        float* z = Qb;                  // R x CR
        float* h1 = Kb;                 // R x R1
        float* h2 = h1 + R * R1;        // R x R2
        float* lg = h2 + R * R2;        // R
        for (int i = tid; i < mt * 16 * CR; i += blockDim.x) {
          const int r = i / CR, c = i - (i / CR) * CR, rg = r0 + r;
          const int p = rg / L, l = rg - (rg / L) * L, gp = p0 + p;
          float val = 0.f;
          if (c < C) {
            val = X[r * LD + c];
            if (r < nr && l == 0 && gp < P) token_out[(size_t)gp * C + c] = val;
          } else if (r < nr && l > 0 && gp < P) {
            val = __ldg(dir + ((size_t)(l - 1) * P + gp) * 3 + c - C);
          }
          z[r * CR + c] = val;
        }
        __syncthreads();
        block_linear<4, kFast>(z, CR, CR, W + D::O_RW0, W + D::O_RB0, h1, R1, mt * 16,
                                      R1, true);
        __syncthreads();
        block_linear<4, kFast>(h1, R1, R1, W + D::O_RW1, W + D::O_RB1, h2, R2, mt * 16,
                                      R2, true);
        __syncthreads();
        block_linear<4, kFast>(h2, R2, R2, W + D::O_RW2, W + D::O_RB2, lg, 1, mt * 16, 1,
                                      false);
        __syncthreads();
        for (int r = tid; r < nr; r += blockDim.x) {
          const int rg = r0 + r, l = rg % L;
          if (l > 0) Ls[(rg / L) * NV + l - 1] = lg[r];
        }
        __syncthreads();
      }
    }

    // the masked softmax over each point's views and the rgb blend, in
    // point_head.cuh's order; a point masked in every view gets uniform
    // weights (the mean rgb), as the JAX softmax does
    for (int p = tid; p < TP; p += blockDim.x) {
      const int gp = p0 + p;
      if (gp >= P) continue;
      const float* lp = Ls + p * NV;
      auto logit = [&](int v) { return mask[(size_t)v * P + gp] == 0.f ? -1e9f : lp[v]; };
      float m = logit(0);
      for (int v = 1; v < NV; ++v) m = fmaxf(m, logit(v));
      float sum = 0.f;
      for (int v = 0; v < NV; ++v) sum += expf(logit(v) - m);
      for (int ch = 0; ch < 3; ++ch) {
        float acc = 0.f;
        for (int v = 0; v < NV; ++v)
          acc = fmaf(rgb[((size_t)v * P + gp) * 3 + ch], expf(logit(v) - m) / sum, acc);
        rad_out[(size_t)gp * 3 + ch] = acc;
      }
    }
    // the next tile reuses the scratch and shared memory
    __syncthreads();
  }
}

// blocks of a streamed launch: one an SM, at most one a tile
static int stream_blocks(int nv, int p) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int tiles = (p + stream_points(nv) - 1) / stream_points(nv);
  return tiles < sms ? tiles : sms;
}

long long stream_scratch_floats(int c, int nv, int p) {
  if (nv <= kMaxViews || p <= 0) return 0;
  return (long long)stream_blocks(nv, p) * stream_block_floats(c, nv);
}

template <bool kFast, int CV>
static int launch_stream_precision(UFO_PH_ARGS, float* scratch, int nv, int p,
                                   cudaStream_t s) {
  constexpr size_t smem = stream_smem_bytes<CV>();
  static_assert(smem <= 232448, "more shared memory than an sm_90 block may have");
  cudaError_t e = cudaFuncSetAttribute(point_head_stream_kernel<CV, kFast>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  point_head_stream_kernel<CV, kFast><<<stream_blocks(nv, p), kPointThreads, smem, s>>>(
      img, vol, sim, dd, dir, rgb, mask, w, token, rad, scratch, nv, p);
  return (int)cudaGetLastError();
}

template <int CV>
int launch_stream(UFO_PH_ARGS, float* scratch, int nv, int p, bool fast, cudaStream_t s) {
  if (nv <= kMaxViews) return (int)cudaErrorInvalidValue;
  return fast ? launch_stream_precision<true, CV>(img, vol, sim, dd, dir, rgb, mask, w, token,
                                                  rad, scratch, nv, p, s)
              : launch_stream_precision<false, CV>(img, vol, sim, dd, dir, rgb, mask, w, token,
                                                   rad, scratch, nv, p, s);
}

template int launch_stream<24>(UFO_PH_ARGS, float* scratch, int nv, int p, bool fast,
                               cudaStream_t s);
template int launch_stream<16>(UFO_PH_ARGS, float* scratch, int nv, int p, bool fast,
                               cudaStream_t s);

}  // namespace ph
}  // namespace ufo
