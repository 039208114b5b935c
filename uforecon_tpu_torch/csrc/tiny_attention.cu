// Tiny-sequence elu+1 linear attention for Hopper (sm_90a): forward and its
// hand-written backward.
//
// Replaces the Pallas TPU kernels of the JAX package's ops/pallas_attention.py:
// tiny_linear_attention (_fwd_tb, body _fwd_kernel) and its custom-VJP
// backward (_bwd_tb, body _bwd_kernel). Over B points (the render chunk's
// RN x SN samples) with L, S <= 8 tokens (the view token and the NV views),
// H heads of D <= 16 and M <= 16 channels:
//   out[l,h,:] = sum_s (phi(q[l,h]) . phi(k[s,h])) v[s,h,:]
//                / (sum_s phi(q[l,h]) . phi(k[s,h]) + 1e-6),
// phi(x) = x + 1 for x > 0, else exp(x). The backward recomputes the scores
// and the denominator and returns dq, dk and dv, with dphi = 1 for x > 0,
// else exp(x) (= min(phi(x), 1), exactly).
//
// What bounds it on the H100: bytes. At the view transformer's shape (L = S =
// 4, H = 8, D = M = 10) a point reads 3 x 320 floats and writes 320 for ~2.6k
// FLOP, ~2 FLOP per byte. The TPU kernel kept the points on the 128 lanes
// (transposed (L*H*D, B) slabs, padded to 128 points); here q, k and v are
// read as they come out of nn.Linear, contiguous (B, L, H, D), with no
// transpose and no padding copy.
//
// Design: a block takes a tile of up to 32 points. Each input's tile is one
// contiguous run of global memory; warps copy it row by row (one point per
// row) into shared memory with cp.async, so every load is coalesced and all
// of a block's loads are in flight at once. Rows are padded to an odd stride,
// so consecutive points' rows start in different banks. One thread
// then computes one (point, head) pair from shared memory, holding one
// query's D features and M accumulators in registers, and writes its
// outputs into a shared tile that the warps store back row by row,
// coalesced. phi(k) is applied once, in place. A block's copies, arithmetic
// and stores run one after the other, so the card overlaps them across
// blocks: the forward's tile is kept to ~40 KB (7 points at the view
// transformer's shape) so that ~6 blocks share an SM; the backward, at 168
// registers a thread, takes ~96 KB (12 points), two blocks to an SM. (A
// sweep on the H100 over 128 or 256 threads and 40-224 KB tiles put these
// first.) Sums over s run in order; all math is FP32 FMA.
#include "common.cuh"

namespace ufo {
namespace ta {

constexpr int kMaxLen = 8;    // L and S
constexpr int kMaxDim = 16;   // D and M
constexpr int kThreads = 128;
constexpr int kMaxTile = 32;
// shared memory a block's tile aims at (see the design note above)
constexpr int kFwdBudget = 40 * 1024;
constexpr int kBwdBudget = 96 * 1024;

struct Dims {
  int b, l, s, h, d, m;
};

// Shared-memory row stride of a point's `row` floats: odd, so that rows of
// consecutive points start in different banks.
__host__ __device__ inline int padded(int row) { return row | 1; }

// Shared floats per point: forward q, k, v, out; backward q (then dq), k,
// v, g, dk, dv.
inline int row_floats(const Dims& t, bool backward) {
  const int q = padded(t.l * t.h * t.d), k = padded(t.s * t.h * t.d);
  const int v = padded(t.s * t.h * t.m), o = padded(t.l * t.h * t.m);
  return backward ? q + 2 * k + 2 * v + o : q + k + v + o;
}

// Points per block: as many as fit the budget, at least one, at most 32;
// 0 when one point's rows exceed Hopper's opt-in shared memory.
inline int tile_points(const Dims& t, bool backward) {
  const long long bytes = 4LL * row_floats(t, backward);
  if (bytes > 232448) return 0;
  const long long n = (backward ? kBwdBudget : kFwdBudget) / bytes;
  return (int)(n < 1 ? 1 : n > kMaxTile ? kMaxTile : n);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// n rows of `row` floats, contiguous in global memory from src, into shared
// rows of stride padded(row); one warp per row, lanes on consecutive floats.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row, int n) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int ld = padded(row);
  for (int p = threadIdx.x >> 5; p < n; p += nw)
    for (int r = lane; r < row; r += 32)
      cp_async4(dst + p * ld + r, src + (size_t)p * row + r);
}

// The reverse: shared rows back to contiguous global rows.
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float* src,
                                           int row, int n) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int ld = padded(row);
  for (int p = threadIdx.x >> 5; p < n; p += nw)
    for (int r = lane; r < row; r += 32) dst[(size_t)p * row + r] = src[p * ld + r];
}

__global__ void __launch_bounds__(kThreads) fwd_kernel(
    const float* __restrict__ q,   // (B, L, H, D)
    const float* __restrict__ k,   // (B, S, H, D)
    const float* __restrict__ v,   // (B, S, H, M)
    float* __restrict__ o,         // (B, L, H, M)
    Dims t, int tile) {
  extern __shared__ float smem[];
  const int H = t.h, D = t.d, M = t.m;
  const int rq = t.l * H * D, rk = t.s * H * D, rv = t.s * H * M, ro = t.l * H * M;
  const int lq = padded(rq), lk = padded(rk), lv = padded(rv), lo = padded(ro);
  float* Q = smem;
  float* K = Q + tile * lq;
  float* V = K + tile * lk;
  float* O = V + tile * lv;
  const size_t p0 = (size_t)blockIdx.x * tile;
  const int n = min(tile, t.b - (int)p0);   // the last tile may be ragged

  load_tile(Q, q + p0 * rq, rq, n);
  load_tile(K, k + p0 * rk, rk, n);
  load_tile(V, v + p0 * rv, rv, n);
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < n * lk; i += blockDim.x) K[i] = phi(K[i]);
  __syncthreads();

  // one (point, head) per thread, points fastest
  for (int idx = threadIdx.x; idx < tile * H; idx += blockDim.x) {
    const int p = idx % tile, h = idx / tile;
    if (p >= n) continue;
    const float* qr = Q + p * lq + h * D;
    const float* kr = K + p * lk + h * D;
    const float* vr = V + p * lv + h * M;
    float* orow = O + p * lo + h * M;
    for (int l = 0; l < t.l; ++l) {
      float qf[kMaxDim], acc[kMaxDim];
#pragma unroll
      for (int d = 0; d < kMaxDim; ++d) {
        qf[d] = d < D ? phi(qr[l * H * D + d]) : 0.f;
        acc[d] = 0.f;
      }
      float den = 0.f;
      for (int s = 0; s < t.s; ++s) {
        const float* ks = kr + s * H * D;
        const float* vs = vr + s * H * M;
        float sc = 0.f;
#pragma unroll
        for (int d = 0; d < kMaxDim; ++d)
          if (d < D) sc = fmaf(qf[d], ks[d], sc);
        den += sc;
#pragma unroll
        for (int m = 0; m < kMaxDim; ++m)
          if (m < M) acc[m] = fmaf(sc, vs[m], acc[m]);
      }
      den += kAttnEps;
#pragma unroll
      for (int m = 0; m < kMaxDim; ++m)
        if (m < M) orow[l * H * M + m] = acc[m] / den;
    }
  }
  __syncthreads();
  store_tile(o + p0 * ro, O, ro, n);
}

__global__ void __launch_bounds__(kThreads) bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v,
    const float* __restrict__ g,   // (B, L, H, M) gradient of the output
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    Dims t, int tile) {
  extern __shared__ float smem[];
  const int H = t.h, D = t.d, M = t.m;
  const int rq = t.l * H * D, rk = t.s * H * D, rv = t.s * H * M, rg = t.l * H * M;
  const int lq = padded(rq), lk = padded(rk), lv = padded(rv), lg = padded(rg);
  float* Q = smem;               // q, overwritten by dq row by row
  float* K = Q + tile * lq;      // phi(k)
  float* V = K + tile * lk;
  float* G = V + tile * lv;
  float* DK = G + tile * lg;     // sum_l ds phi(q), times dphi(k) at the end
  float* DV = DK + tile * lk;
  const size_t p0 = (size_t)blockIdx.x * tile;
  const int n = min(tile, t.b - (int)p0);   // the last tile may be ragged

  load_tile(Q, q + p0 * rq, rq, n);
  load_tile(K, k + p0 * rk, rk, n);
  load_tile(V, v + p0 * rv, rv, n);
  load_tile(G, g + p0 * rg, rg, n);
  for (int i = threadIdx.x; i < n * lk; i += blockDim.x) DK[i] = 0.f;
  for (int i = threadIdx.x; i < n * lv; i += blockDim.x) DV[i] = 0.f;
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < n * lk; i += blockDim.x) K[i] = phi(K[i]);
  __syncthreads();

  for (int idx = threadIdx.x; idx < tile * H; idx += blockDim.x) {
    const int p = idx % tile, h = idx / tile;
    if (p >= n) continue;
    float* qr = Q + p * lq + h * D;
    const float* kr = K + p * lk + h * D;
    const float* vr = V + p * lv + h * M;
    const float* gr = G + p * lg + h * M;
    float* dkr = DK + p * lk + h * D;
    float* dvr = DV + p * lv + h * M;
    for (int l = 0; l < t.l; ++l) {
      float qf[kMaxDim], gl[kMaxDim], out[kMaxDim], dqf[kMaxDim], sc[kMaxLen];
#pragma unroll
      for (int d = 0; d < kMaxDim; ++d) {
        qf[d] = d < D ? phi(qr[l * H * D + d]) : 0.f;
        gl[d] = d < M ? gr[l * H * M + d] : 0.f;
        out[d] = 0.f;
        dqf[d] = 0.f;
      }
      // recompute the scores, the denominator and the output
      float den = 0.f;
#pragma unroll
      for (int s = 0; s < kMaxLen; ++s) {
        sc[s] = 0.f;
        if (s < t.s) {
          const float* ks = kr + s * H * D;
          const float* vs = vr + s * H * M;
#pragma unroll
          for (int d = 0; d < kMaxDim; ++d)
            if (d < D) sc[s] = fmaf(qf[d], ks[d], sc[s]);
          den += sc[s];
#pragma unroll
          for (int m = 0; m < kMaxDim; ++m)
            if (m < M) out[m] = fmaf(sc[s], vs[m], out[m]);
        }
      }
      den += kAttnEps;
#pragma unroll
      for (int m = 0; m < kMaxDim; ++m) out[m] /= den;
#pragma unroll
      for (int s = 0; s < kMaxLen; ++s) {
        if (s < t.s) {
          const float* ks = kr + s * H * D;
          const float* vs = vr + s * H * M;
          // ds = sum_m g (v_s - out) / den; dv_s += sc / den * g
          float acc = 0.f;
#pragma unroll
          for (int m = 0; m < kMaxDim; ++m)
            if (m < M) acc = fmaf(gl[m], vs[m] - out[m], acc);
          const float ds = acc / den;
          const float w = sc[s] / den;
#pragma unroll
          for (int m = 0; m < kMaxDim; ++m)
            if (m < M) dvr[s * H * M + m] = fmaf(w, gl[m], dvr[s * H * M + m]);
#pragma unroll
          for (int d = 0; d < kMaxDim; ++d)
            if (d < D) {
              dqf[d] = fmaf(ds, ks[d], dqf[d]);
              dkr[s * H * D + d] = fmaf(ds, qf[d], dkr[s * H * D + d]);
            }
        }
      }
      // dq over the row's q, which this thread alone reads
#pragma unroll
      for (int d = 0; d < kMaxDim; ++d)
        if (d < D) qr[l * H * D + d] = dqf[d] * fminf(qf[d], 1.f);
    }
    for (int s = 0; s < t.s; ++s)
#pragma unroll
      for (int d = 0; d < kMaxDim; ++d)
        if (d < D) dkr[s * H * D + d] *= fminf(kr[s * H * D + d], 1.f);
  }
  __syncthreads();
  store_tile(dq + p0 * rq, Q, rq, n);
  store_tile(dk + p0 * rk, DK, rk, n);
  store_tile(dv + p0 * rv, DV, rv, n);
}

inline bool dims_ok(const Dims& t) {
  return t.b >= 0 && t.l >= 1 && t.l <= kMaxLen && t.s >= 1 && t.s <= kMaxLen &&
         t.h >= 1 && t.d >= 1 && t.d <= kMaxDim && t.m >= 1 && t.m <= kMaxDim;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Dims& t, bool backward, void* stream, Args... args) {
  if (!dims_ok(t)) return (int)cudaErrorInvalidValue;
  if (t.b == 0) return 0;
  const int tile = tile_points(t, backward);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)tile * row_floats(t, backward);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((t.b + tile - 1) / tile);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args..., t,
                                                                        tile);
  return (int)cudaGetLastError();
}

}  // namespace ta
}  // namespace ufo

// Both return a cudaError_t value (0 on success): cudaErrorInvalidValue for
// L or S outside 1..8, D or M outside 1..16, or rows that do not fit in
// shared memory. Tensors are contiguous float32.
extern "C" int ufo_tiny_attention_fwd(const float* q, const float* k, const float* v,
                                      float* o, int b, int l, int s, int h, int d,
                                      int m, void* stream) {
  const ufo::ta::Dims t{b, l, s, h, d, m};
  return ufo::ta::launch(ufo::ta::fwd_kernel, t, false, stream, q, k, v, o);
}

extern "C" int ufo_tiny_attention_bwd(const float* q, const float* k, const float* v,
                                      const float* g, float* dq, float* dk, float* dv,
                                      int b, int l, int s, int h, int d, int m,
                                      void* stream) {
  const ufo::ta::Dims t{b, l, s, h, d, m};
  return ufo::ta::launch(ufo::ta::bwd_kernel, t, true, stream, q, k, v, g, dq, dk,
                         dv);
}
