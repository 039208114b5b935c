// Split-weight per-point view head for Hopper (sm_90a) at any view count
// above the compiled-in ones (NV > kMaxViews = 11), in both precisions.
//
// The JAX kernel (ops/fused_point_head2.py _kernel) takes any count. Past
// 11 views a tile's view rows outgrow point_head2.cuh's resident tile (144
// view rows), so this kernel keeps that kernel's algebra (the view-shared
// projections once per point, the view rows' sums started from them) and
// streams the view rows through a chunk of kChunkRows rows, with the count
// a runtime value, in two passes over a tile of TP = 8 points:
//   0. once a tile: the pre-similarity MLP, the view-shared projections
//      (q | k and v into the token rows, mlp1 | r0 into T), which stay in
//      place for every chunk;
//   1. each chunk's view rows [img | pe | dir | 1] are built and their keys
//      phi(... + shared k) and values go to global scratch (the block's
//      own slice, in the L2);
//   2. each chunk's view rows are built again: q, the linear attention over
//      the point's L tokens (token 0's q, k, v the constants; the others'
//      keys and values from scratch; q.k per token, then over the tokens
//      in order), merge, LayerNorm, mlp1, mlp2, LayerNorm, and radiance
//      layer 0 and its 16 -> 8 -> 1 tail, whose logits go to scratch. The
//      token rows take part in the last chunk only, so that until then
//      they keep the shared parts the view rows start from.
// A tile ends with the masked softmax (masked at -1e9, as JAX) and the rgb
// blend in point_head2.cuh's order. Same gemms, same rounding sites in
// 'fast' (the attention's bf16-rounded products, score and denominator),
// but there the products are added by FP32 FMAs, k in order (tc_gemm.cuh
// kFmaSum), as kernel 1 adds them from 6 views on: with the tensor cores'
// own sums, the radiance of 49 views blends 49 logits that each moved by a
// few FP32 units, and 0.861 of its elements stayed within the plain
// version's tolerance where chip_smoke's rule asks 0.9.
// Blocks are persistent, one an SM (211,648 bytes of shared memory at
// tokens of 80), so the scratch is bounded by the SM count, not by P.
//
// What bounds it: the resident kernel's arithmetic, plus the rebuilt view
// rows and the keys and values read from the L2 (L^2 2C floats a point),
// with one block an SM and its syncs unhidden: the rare path, timed in
// PERF.md.
#include "point_head2.cuh"

namespace ufo {
namespace ph2 {

constexpr int kStreamPoints = 8;    // points of a streamed tile
constexpr int kChunkRows = 128;     // view rows of a chunk: 8 m16 tiles
constexpr int kStreamRowsAll = RT + kChunkRows;

__host__ __device__ inline int stream_chunks(int nv) {
  return (kStreamPoints * nv + kChunkRows - 1) / kChunkRows;
}

// floats of scratch a block takes: the keys and values of its tile's view
// rows (whole chunks), then the logits
__host__ __device__ inline long long stream_block_floats(int c, int nv) {
  return (long long)stream_chunks(nv) * kChunkRows * 2 * c + (long long)kStreamPoints * nv;
}

template <int CV>
constexpr size_t stream_smem_bytes() {
  using D = Dims<CV>;
  return sizeof(float) * ((size_t)kStreamRowsAll * (D::LQK + D::LV + LX) +
                          RT * (D::LS + D::LT) + 3 * D::C + tc::ring_floats(kStages, D::NTAIL));
}

template <int CV, bool kFast>
__global__ void __launch_bounds__(kThreads, 1) point_head2_stream_kernel(
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
  constexpr int C = D::C, DK = D::DK, C2 = D::C2, GS = D::GS, NSH = D::NSH,
                NTAIL = D::NTAIL, LS = D::LS, LQK = D::LQK, LV = D::LV, LT = D::LT;
  constexpr int TP = kStreamPoints;
  constexpr int R = kStreamRowsAll;   // RT token rows, then a chunk of view rows
  constexpr int VT = kChunkRows / 16, AT = R / 16;
  constexpr int NW = kThreads / 32;
  constexpr int NT_SQK = tc::col_tiles(NW, 1, 2 * C);
  constexpr int NT_SV = tc::col_tiles(NW, 1, C);
  constexpr int NT_ST = tc::col_tiles(NW, 1, NTAIL);
  constexpr int NT_VC = tc::col_tiles(NW, VT, C);
  constexpr int NT_C = tc::col_tiles(NW, AT, C);
  constexpr int NT_C2 = tc::col_tiles(NW, AT, C2);
  constexpr int NT_R = tc::col_tiles(NW, VT, R1);
  static_assert(AT <= NW, "a row tile per warp");
  static_assert(TP <= RT, "the token rows fit one tile");
  static_assert(kChunkRows * (LZ + R2 + 1) <= kChunkRows * LQK, "radiance scratch must fit q|k");
  static_assert(TP * (SIN + 2 * SHID) <= RT * LQK, "similarity scratch must fit q|k");
  extern __shared__ float4 smem4[];
  float* QK = reinterpret_cast<float*>(smem4);  // R x LQK q | k -> attention out; mlp1 out
  float* Vb = QK + R * LQK;           // R x LV   v -> message -> m2
  float* X = Vb + R * LV;             // R x LX   token rows 0, view rows [img|pe|dir|1|0]
  float* S = X + R * LX;              // RT x LS  [vol | sim16]
  float* T = S + RT * LS;             // RT x LT  shared mlp1 | r0 parts
  float* tok3 = T + RT * LT;          // phi(token q) | phi(token k) | token v
  float* ring = tok3 + 3 * C;         // weight slots
  const int tid = threadIdx.x;
  const int L = NV + 1;
  const int RV = TP * NV;             // the tile's view rows, row p NV + v
  const int nchunks = stream_chunks(NV);
  float* Ks = scratch + (size_t)blockIdx.x * stream_block_floats(C, NV);
  float* Vs = Ks + (size_t)nchunks * kChunkRows * C;
  float* Ls = Vs + (size_t)nchunks * kChunkRows * C;   // RV logits
  const int tiles = (P + TP - 1) / TP;

  for (int i = tid; i < 3 * C; i += blockDim.x) {
    const float t = __ldg(W + D::O_TQKV + i);
    tok3[i] = i < 2 * C ? phi(t) : t;
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile * TP;
    // 0. the tile's raw cosines to scratch in QK, volume features into S
    //    (zero past the tile and past P), the token rows of X zero
    float* s_in = QK;
    float* s_h1 = s_in + TP * SIN;
    float* s_h2 = s_h1 + TP * SHID;
    for (int i = tid; i < TP * SIN; i += blockDim.x) {
      const int gp = p0 + i / SIN;
      s_in[i] = gp < P ? sim[(size_t)gp * SIN + i % SIN] : 0.f;
    }
    for (int i = tid; i < RT * LS; i += blockDim.x) {
      const int p = i / LS, c = i % LS, gp = p0 + p;
      S[i] = p < TP && gp < P && c < CV ? vol[(size_t)gp * CV + c] : 0.f;
    }
    for (int i = tid; i < RT * LX; i += blockDim.x) X[i] = 0.f;
    __syncthreads();
    block_linear<kSmallRows, kFast>(s_in, SIN, SIN, W + D::O_SW0, W + D::O_SB0, s_h1,
                                           SHID, TP, SHID, true);
    __syncthreads();
    block_linear<kSmallRows, kFast>(s_h1, SHID, SHID, W + D::O_SW1, W + D::O_SB1, s_h2,
                                           SHID, TP, SHID, true);
    __syncthreads();
    block_linear<kSmallRows, kFast>(s_h2, SHID, SHID, W + D::O_SW2, W + D::O_SB2, S + CV,
                                           LS, TP, SOUT, false);
    __syncthreads();
    // the view-shared projections (point_head2.cuh step 3)
    tc::gemm<kStages, NT_SQK, kFast, kFast>(S, LS, GS, nullptr, 0, 0, W + D::O_SH, ring, QK,
                                            LQK, 1, 2 * C, false, NSH);
    tc::gemm<kStages, NT_SV, kFast, kFast>(S, LS, GS, nullptr, 0, 0, W + D::O_SH + 2 * C, ring,
                                           Vb, LV, 1, C, false, NSH);
    tc::gemm<kStages, NT_ST, kFast, kFast>(S, LS, GS, nullptr, 0, 0, W + D::O_SH + 3 * C, ring,
                                           T, LT, 1, NTAIL, false, NSH);

    for (int pass = 0; pass < 2; ++pass) {
      for (int ch = 0; ch < nchunks; ++ch) {
        const int c0 = ch * kChunkRows;                // the chunk's first view row
        const int nr = RV - c0 < kChunkRows ? RV - c0 : kChunkRows;
        const int mv = (nr + 15) / 16;                 // m16 tiles of its view rows
        const bool last = ch == nchunks - 1;
        float* XV = X + RT * LX;
        // the chunk's view rows [img | pe | dir | 1 1 1 | 0...], zero past
        // the tile's view rows
        for (int i = tid; i < mv * 16 * LX; i += blockDim.x) {
          const int r = i / LX, c = i - (i / LX) * LX, vg = c0 + r;
          const int p = vg / NV, v = vg - (vg / NV) * NV, gp = p0 + p;
          float val = 0.f;
          if (vg < RV) {
            if (c >= XW && c < XW + NB) {
              val = 1.f;
            } else if (gp < P) {
              const size_t pv = (size_t)v * P + gp;
              if (c < CI) {
                val = __ldg(img + pv * CI + c);
              } else if (c < GV) {
                const int k = c - CI;
                const float f = ldexpf(kPi, k >> 1);
                const float ph = (k & 1) ? 0.5f * kPi : 0.f;
                // the product and the sum rounded apart, as the plain
                // version's x * f + ph
                val = sinf(__fadd_rn(__fmul_rn(__ldg(dd + pv), f), ph));
              } else if (c < XW) {
                val = __ldg(dir + pv * 3 + c - GV);
              }
            }
          }
          XV[r * LX + c] = val;
        }
        __syncthreads();

        if (pass == 0) {
          // keys and values, each view row from its point's shared part
          tc::gemm<kStages, NT_VC, kFast, kFast>(XV, LX, GV, nullptr, 0, 0, W + D::O_VQKV + C,
                                                 ring, Ks + (size_t)c0 * C, C, mv, C, tc::kPhi,
                                                 3 * C, QK + C, LQK, NV, c0);
          tc::gemm<kStages, NT_VC, kFast, kFast>(XV, LX, GV, nullptr, 0, 0,
                                                 W + D::O_VQKV + 2 * C, ring,
                                                 Vs + (size_t)c0 * C, C, mv, C, tc::kNone,
                                                 3 * C, Vb, LV, NV, c0);
          continue;
        }

        tc::gemm<kStages, NT_VC, kFast, kFast>(XV, LX, GV, nullptr, 0, 0, W + D::O_VQKV, ring,
                                               QK + RT * LQK, LQK, mv, C, tc::kPhi, 3 * C, QK,
                                               LQK, NV, c0);
        // linear attention: the chunk's view rows, and in the last chunk
        // the token rows too, each over its point's L tokens, per head
        const int items = nr + (last ? TP : 0);
        for (int t = tid; t < items * NH; t += blockDim.x) {
          const int it = t / NH, h = t - (t / NH) * NH;
          const bool tok = it >= nr;
          const int p = tok ? it - nr : (c0 + it) / NV;
          const int row = tok ? p : RT + it;
          const float* qs = tok ? tok3 + h * DK : QK + row * LQK + h * DK;
          float q[DK], acc[DK];
#pragma unroll
          for (int d = 0; d < DK; ++d) {
            q[d] = qs[d];
            acc[d] = 0.f;
          }
          float den = 0.f;
          for (int s = 0; s < L; ++s) {
            const size_t rs = (size_t)(p * NV + s - 1) * C + h * DK;
            const float* ks = s == 0 ? tok3 + C + h * DK : Ks + rs;
            const float* vv = s == 0 ? tok3 + 2 * C + h * DK : Vs + rs;
            float sc = 0.f;
#pragma unroll
            for (int d = 0; d < DK; ++d)
              sc = kFast ? sc + bf16_round(q[d] * ks[d]) : fmaf(q[d], ks[d], sc);
            den += sc;
            const float w = kFast ? bf16_round(sc) : sc;
#pragma unroll
            for (int d = 0; d < DK; ++d) acc[d] = fmaf(w, vv[d], acc[d]);
          }
          den = (kFast ? bf16_round(den) : den) + kAttnEps;
          float* out = QK + row * LQK + h * DK;
#pragma unroll
          for (int d = 0; d < DK; ++d) out[d] = acc[d] / den;
        }
        __syncthreads();

        // the rows of this chunk's layer chain: the token tile in the last
        // chunk, then the view rows
        const int a0 = last ? 0 : RT;
        const int mt = (last ? 1 : 0) + mv;
        // merge + LayerNorm -> the message in Vb
        tc::gemm<kStages, NT_C, kFast, kFast>(QK + a0 * LQK, LQK, C, nullptr, 0, 0, W + D::O_WM,
                                              ring, Vb + a0 * LV, LV, mt, C, false);
        tc::layernorm<C>(Vb + a0 * LV, LV, mt * 16, W + D::O_N1S, W + D::O_N1B);
        // mlp1 over [[img | pe] | message] -> QK, + w1a_tok or the point's
        // shared part, relu
        tc::gemm<kStages, NT_C2, kFast, kFast>(X + a0 * LX, LX, GV, Vb + a0 * LV, LV, C,
                                               W + D::O_VW1, ring, QK + a0 * LQK, LQK, mt, C2,
                                               false);
        constexpr int C2_4 = C2 / 4;
        for (int i = tid; i < mt * 16 * C2_4; i += blockDim.x) {
          const int r = a0 + i / C2_4, j = 4 * (i - (i / C2_4) * C2_4);
          const float4 b = r < RT ? __ldg(reinterpret_cast<const float4*>(W + D::O_W1T + j))
                                  : *reinterpret_cast<const float4*>(
                                        T + ((c0 + r - RT) / NV) * LT + j);
          float4* y = reinterpret_cast<float4*>(QK + r * LQK + j);
          const float4 x = *y;
          *y = make_float4(fmaxf(x.x + b.x, 0.f), fmaxf(x.y + b.y, 0.f), fmaxf(x.z + b.z, 0.f),
                           fmaxf(x.w + b.w, 0.f));
        }
        __syncthreads();
        // mlp2 + LayerNorm -> m2 in Vb
        tc::gemm<kStages, NT_C, kFast, kFast>(QK + a0 * LQK, LQK, C2, nullptr, 0, 0,
                                              W + D::O_W2, ring, Vb + a0 * LV, LV, mt, C,
                                              false);
        tc::layernorm<C>(Vb + a0 * LV, LV, mt * 16, W + D::O_N2S, W + D::O_N2B);
        if (last) {
          for (int i = tid; i < TP * C; i += blockDim.x) {
            const int p = i / C, c = i - (i / C) * C;
            if (p0 + p < P)
              token_out[(size_t)(p0 + p) * C + c] = __ldg(W + D::O_TOK + c) + Vb[p * LV + c];
          }
        }
        // radiance layer 0 over [img | pe | dir | 1 | 0] and m2 of each
        // view row, from its point's shared part, relu; then 16 -> 8 -> 1
        float* z = QK + RT * LQK;       // view rows x LZ (mlp1's output is dead)
        float* h2 = z + kChunkRows * LZ;
        float* lg = h2 + kChunkRows * R2;
        tc::gemm<kStages, NT_R, kFast, kFast>(XV, LX, XK, Vb + RT * LV, LV, C, W + D::O_VRAD,
                                              ring, z, LZ, mv, R1, tc::kRelu, 0, T + C2, LT, NV,
                                              c0);
        block_linear<kSmallRows, kFast>(z, LZ, R1, W + D::O_RW1, W + D::O_RB1, h2, R2,
                                               mv * 16, R2, true);
        __syncthreads();
        block_linear<kSmallRows, kFast>(h2, R2, R2, W + D::O_RW2, W + D::O_RB2, lg, 1,
                                               mv * 16, 1, false);
        __syncthreads();
        for (int r = tid; r < nr; r += blockDim.x) Ls[c0 + r] = lg[r];
        __syncthreads();
      }
    }

    // the masked softmax over each point's views and the rgb blend; a
    // point masked in all views gets uniform weights (the mean rgb)
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

static int stream_blocks(int nv, int p) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms = 132;
  const int tiles = (p + kStreamPoints - 1) / kStreamPoints;
  return tiles < sms ? tiles : sms;
}

long long stream_scratch_floats(int c, int nv, int p) {
  if (nv <= kMaxViews || p <= 0) return 0;
  return (long long)stream_blocks(nv, p) * stream_block_floats(c, nv);
}

template <bool kFast, int CV>
static int launch_stream_precision(UFO_PH2_ARGS, float* scratch, int nv, int p,
                                   cudaStream_t s) {
  constexpr size_t smem = stream_smem_bytes<CV>();
  static_assert(smem <= 232448, "more shared memory than an sm_90 block may have");
  cudaError_t e = cudaFuncSetAttribute(point_head2_stream_kernel<CV, kFast>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  point_head2_stream_kernel<CV, kFast><<<stream_blocks(nv, p), kThreads, smem, s>>>(
      img, vol, sim, dd, dir, rgb, mask, w, token, rad, scratch, nv, p);
  return (int)cudaGetLastError();
}

template <int CV>
int launch_stream(UFO_PH2_ARGS, float* scratch, int nv, int p, bool fast, cudaStream_t s) {
  if (nv <= kMaxViews) return (int)cudaErrorInvalidValue;
  return fast ? launch_stream_precision<true, CV>(img, vol, sim, dd, dir, rgb, mask, w, token,
                                                  rad, scratch, nv, p, s)
              : launch_stream_precision<false, CV>(img, vol, sim, dd, dir, rgb, mask, w, token,
                                                   rad, scratch, nv, p, s);
}

template int launch_stream<24>(UFO_PH2_ARGS, float* scratch, int nv, int p, bool fast,
                               cudaStream_t s);
template int launch_stream<16>(UFO_PH2_ARGS, float* scratch, int nv, int p, bool fast,
                               cudaStream_t s);

}  // namespace ph2
}  // namespace ufo
