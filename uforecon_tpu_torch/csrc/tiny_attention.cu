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
// Forward design: persistent blocks (as many as are resident at once)
// walk over tiles of points. Each input's tile is one contiguous run of
// global memory, so it arrives by one 1-D TMA bulk copy (cp.async.bulk ...
// mbarrier::complete_tx) started by one thread into a ring of two stages:
// tile i + 1 loads while tile i computes, and no thread spends
// instructions on the copies. A tile holds ~128 (point, query token l,
// head) items (4 points at L = 4, H = 8), one per thread of a 128-thread
// block, ~41 KB with both stages, so five blocks share an SM and overlap
// one another's arithmetic with their copies. (On the H100 at route A's
// shape, timed with script/head_variants.py: three stages of 8 points at
// 256 threads, two blocks an SM, took 0.138 ms; this shape 0.124 ms; with
// no arithmetic at all the stream takes 0.116 ms.) phi(k) is applied once
// per stage, in place; the S scores of an item are taken first, as
// independent dot products. The output goes into one of two shared tiles
// and leaves by a TMA bulk store while the next tile computes. Bulk copies
// cannot pad rows, so bank conflicts are kept down by the thread mapping:
// item (p, l, h) is thread p L H + l H + h, so its q and output rows are
// consecutive runs of D and M floats, read and written as float4 (D, M %
// 4 == 0) or float2 (even) pieces, conflict-free; the threads of a point
// share its k and v rows (a broadcast), and at D = M = 10 (float2) they
// read them conflict-free, at D = M = 8 (float4) 2-way (bank arithmetic of
// the mapping; the card's tools cannot count conflicts there). Bulk copies
// need 16-byte addresses and sizes: the wrapper passes 16-byte-aligned
// tensors, a tile holds a multiple of 4 points where a point's row is not a
// multiple of 4 floats, and the ragged last tile loads and stores element
// by element. Sums over s run in order in FP32 FMA; the output is the sum
// times the reciprocal of the denominator.
//
// Backward design (unchanged since its port): a block takes a tile of up
// to 32 points. Each input's tile is copied row by row (one point per row,
// one warp a row) into shared memory with cp.async, so every load is
// coalesced and all of a block's loads are in flight at once. Rows are
// padded to an odd stride, so consecutive points' rows start in different
// banks. One thread then computes one (point, head) pair from shared
// memory, holding one query's D features and M accumulators in registers,
// and writes its outputs into shared tiles that the warps store back row
// by row, coalesced. Its copies, arithmetic and stores run one after the
// other, so the card overlaps them across blocks: at 168 registers a
// thread, its tile is ~96 KB (12 points at the view transformer's shape),
// two blocks to an SM (a sweep on the H100 over 128 or 256 threads and
// 40-224 KB tiles put this first).
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace ufo {
namespace ta {

constexpr int kMaxLen = 8;    // L and S
constexpr int kMaxDim = 16;   // D and M
constexpr int kSmemMax = 232448;   // Hopper's opt-in shared memory per block

struct Dims {
  int b, l, s, h, d, m;
};

// ---- forward: persistent blocks fed by TMA bulk copies ----

constexpr int kFwdThreads = 128;
constexpr int kFwdItems = 128;     // (point, l, h) items a tile aims at
constexpr int kFwdStages = 2;      // input stages in the ring
constexpr int kFwdMaxTile = 64;

// A forward tile: points, input stages and shared bytes (0 points when
// the stages of the smallest tile do not fit).
struct FwdPlan {
  int tile, stages;
  size_t smem;
};

inline FwdPlan fwd_plan(const Dims& t) {
  const int rq = t.l * t.h * t.d, rk = t.s * t.h * t.d;
  const int rv = t.s * t.h * t.m, ro = t.l * t.h * t.m;
  // tiles hold a multiple of g points, so that every tile is a multiple
  // of 16 bytes
  int g = 1;
  for (int r : {rq, rk, rv, ro})
    while ((g * r) % 4) g *= 2;
  auto bytes = [&](int tile, int stages) {
    return sizeof(float) * (size_t)tile * ((size_t)stages * (rq + rk + rv) + 2 * ro) +
           sizeof(unsigned long long) * stages;
  };
  int tile = kFwdItems / (t.l * t.h);
  tile = tile > kFwdMaxTile ? kFwdMaxTile : tile;
  tile = tile < g ? g : tile / g * g;
  while (bytes(tile, kFwdStages) > (size_t)kSmemMax) {
    if (tile == g) return {0, 0, 0};
    tile -= g;
  }
  return {tile, kFwdStages, bytes(tile, kFwdStages)};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that expects `bytes` of bulk copies to complete the phase
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, `bytes` (a multiple of 16) completing on bar
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// shared -> global as one bulk-copy group
__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every bulk store but the latest N has read its shared tile
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes, visible to the bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// n floats from shared memory into r[0, n), zero past n; VW floats a load
template <int VW>
__device__ __forceinline__ void load_row(float (&r)[kMaxDim], const float* src, int n) {
#pragma unroll
  for (int i = 0; i < kMaxDim; i += VW) {
    if (i < n) {
      if constexpr (VW == 4) {
        const float4 x = *reinterpret_cast<const float4*>(src + i);
        r[i] = x.x; r[i + 1] = x.y; r[i + 2] = x.z; r[i + 3] = x.w;
      } else if constexpr (VW == 2) {
        const float2 x = *reinterpret_cast<const float2*>(src + i);
        r[i] = x.x; r[i + 1] = x.y;
      } else {
        r[i] = src[i];
      }
    } else {
#pragma unroll
      for (int j = 0; j < VW; ++j) r[i + j] = 0.f;
    }
  }
}

template <int VW>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[kMaxDim], int n) {
#pragma unroll
  for (int i = 0; i < kMaxDim; i += VW) {
    if (i < n) {
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(dst + i) = make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
      } else if constexpr (VW == 2) {
        *reinterpret_cast<float2*>(dst + i) = make_float2(r[i], r[i + 1]);
      } else {
        dst[i] = r[i];
      }
    }
  }
}

// The attention of a tile's n points from shared memory: Q (n, L, H, D),
// K = phi(k) (n, S, H, D), V (n, S, H, M) into O (n, L, H, M); item
// (p, l, h) is idx = (p L + l) H + h. The S scores are independent dot
// products, taken first so that their loads and FMAs interleave; the
// denominator and the weighted sum then run over s in order.
template <int VW>
__device__ __forceinline__ void attend(const float* Q, const float* K, const float* V,
                                       float* O, const Dims& t, int n) {
  const int H = t.h, D = t.d, M = t.m;
  for (int idx = threadIdx.x; idx < n * t.l * H; idx += blockDim.x) {
    const int h = idx % H, p = idx / (H * t.l);
    const float* kp = K + ((size_t)p * t.s * H + h) * D;   // k[p, s, h] at kp + s H D
    const float* vp = V + ((size_t)p * t.s * H + h) * M;
    float qf[kMaxDim], row[kMaxDim], sc[kMaxLen], acc[kMaxDim];
    load_row<VW>(qf, Q + (size_t)idx * D, D);
#pragma unroll
    for (int d = 0; d < kMaxDim; ++d) {
      qf[d] = d < D ? phi(qf[d]) : 0.f;
      acc[d] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < kMaxLen; ++s) {
      sc[s] = 0.f;
      if (s < t.s) {
        load_row<VW>(row, kp + (size_t)s * H * D, D);
#pragma unroll
        for (int d = 0; d < kMaxDim; ++d)
          if (d < D) sc[s] = fmaf(qf[d], row[d], sc[s]);
      }
    }
    float den = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxLen; ++s)
      if (s < t.s) den += sc[s];
    den += kAttnEps;
#pragma unroll
    for (int s = 0; s < kMaxLen; ++s) {
      if (s < t.s) {
        load_row<VW>(row, vp + (size_t)s * H * M, M);
#pragma unroll
        for (int m = 0; m < kMaxDim; ++m)
          if (m < M) acc[m] = fmaf(sc[s], row[m], acc[m]);
      }
    }
    const float inv = 1.f / den;
#pragma unroll
    for (int m = 0; m < kMaxDim; ++m) acc[m] *= inv;
    store_row<VW>(O + (size_t)idx * M, acc, M);
  }
}

template <int VW>
__global__ void __launch_bounds__(kFwdThreads, 2) fwd_kernel(
    const float* __restrict__ q,   // (B, L, H, D)
    const float* __restrict__ k,   // (B, S, H, D)
    const float* __restrict__ v,   // (B, S, H, M)
    float* __restrict__ o,         // (B, L, H, M)
    Dims t, int tile, int stages) {
  extern __shared__ float4 smem4[];
  const int rq = t.l * t.h * t.d, rk = t.s * t.h * t.d;
  const int rv = t.s * t.h * t.m, ro = t.l * t.h * t.m;
  const int stage_floats = tile * (rq + rk + rv);
  float* ring = reinterpret_cast<float*>(smem4);       // stages x [Q | K | V]
  float* obuf = ring + stages * stage_floats;          // 2 x tile x ro
  auto* full = reinterpret_cast<unsigned long long*>(obuf + 2 * tile * ro);
  const int tid = threadIdx.x;
  const int nfull = t.b / tile;                        // whole tiles
  // this block's whole tiles: blockIdx.x + i gridDim.x, i < mine
  const int mine = (int)blockIdx.x < nfull ? (nfull - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t bq = 4u * tile * rq, bk = 4u * tile * rk, bv = 4u * tile * rv;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0 keeps the ring full: tile i into stage i % stages
  auto fetch = [&](int i) {
    const int s = i % stages;
    float* Qs = ring + s * stage_floats;
    const size_t p0 = (size_t)(blockIdx.x + (size_t)i * gridDim.x) * tile;
    mbar_expect(full + s, bq + bk + bv);
    bulk_load(Qs, q + p0 * rq, bq, full + s);
    bulk_load(Qs + tile * rq, k + p0 * rk, bk, full + s);
    bulk_load(Qs + tile * (rq + rk), v + p0 * rv, bv, full + s);
  };
  if (tid == 0)
    for (int i = 0; i < stages && i < mine; ++i) fetch(i);

  for (int i = 0; i < mine; ++i) {
    const int s = i % stages;
    float* Qs = ring + s * stage_floats;
    float* Ks = Qs + tile * rq;
    float* Vs = Ks + tile * rk;
    float* Os = obuf + (i & 1) * tile * ro;
    mbar_wait(full + s, (i / stages) & 1);
    // the store of tile i - 2 is done reading Os
    if (tid == 0) bulk_wait_read<1>();
    float4* K4 = reinterpret_cast<float4*>(Ks);
    for (int j = tid; j < tile * rk / 4; j += blockDim.x) {
      const float4 x = K4[j];
      K4[j] = make_float4(phi(x.x), phi(x.y), phi(x.z), phi(x.w));
    }
    __syncthreads();
    attend<VW>(Qs, Ks, Vs, Os, t, tile);
    fence_async_shared();
    // Os is whole and the stage is free
    __syncthreads();
    if (tid == 0) {
      bulk_store(o + (size_t)(blockIdx.x + (size_t)i * gridDim.x) * tile * ro, Os,
                 4u * tile * ro);
      if (i + stages < mine) fetch(i + stages);
    }
  }

  // the ragged last tile, element by element, by the block whose turn it is
  const int n = t.b - nfull * tile;
  if (n > 0 && (int)blockIdx.x == nfull % (int)gridDim.x) {
    float* Qs = ring;
    float* Ks = Qs + tile * rq;
    float* Vs = Ks + tile * rk;
    const size_t p0 = (size_t)nfull * tile;
    if (tid == 0) bulk_wait_read<0>();
    for (int j = tid; j < n * rq; j += blockDim.x) Qs[j] = q[p0 * rq + j];
    for (int j = tid; j < n * rk; j += blockDim.x) Ks[j] = phi(k[p0 * rk + j]);
    for (int j = tid; j < n * rv; j += blockDim.x) Vs[j] = v[p0 * rv + j];
    __syncthreads();
    attend<VW>(Qs, Ks, Vs, obuf, t, n);
    __syncthreads();
    for (int j = tid; j < n * ro; j += blockDim.x) o[p0 * ro + j] = obuf[j];
  }
  if (tid == 0) bulk_wait_all();
}

// ---- backward ----

constexpr int kThreads = 128;
constexpr int kMaxTile = 32;
constexpr int kBwdBudget = 96 * 1024;   // shared memory a tile aims at

// Shared-memory row stride of a point's `row` floats: odd, so that rows of
// consecutive points start in different banks.
__host__ __device__ inline int padded(int row) { return row | 1; }

// Shared floats per point of the backward: q (then dq), k, v, g, dk, dv.
inline int row_floats(const Dims& t) {
  const int q = padded(t.l * t.h * t.d), k = padded(t.s * t.h * t.d);
  const int v = padded(t.s * t.h * t.m), o = padded(t.l * t.h * t.m);
  return q + 2 * k + 2 * v + o;
}

// Points per backward block: as many as fit the budget, at least one, at
// most 32; 0 when one point's rows exceed Hopper's opt-in shared memory.
inline int tile_points(const Dims& t) {
  const long long bytes = 4LL * row_floats(t);
  if (bytes > kSmemMax) return 0;
  const long long n = kBwdBudget / bytes;
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

int launch_bwd(const float* q, const float* k, const float* v, const float* g,
               float* dq, float* dk, float* dv, const Dims& t, cudaStream_t stream) {
  if (!dims_ok(t)) return (int)cudaErrorInvalidValue;
  if (t.b == 0) return 0;
  const int tile = tile_points(t);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)tile * row_floats(t);
  cudaError_t e = cudaFuncSetAttribute(
      bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned blocks = (unsigned)((t.b + tile - 1) / tile);
  bwd_kernel<<<blocks, kThreads, smem, stream>>>(q, k, v, g, dq, dk, dv, t, tile);
  return (int)cudaGetLastError();
}

template <int VW>
int launch_fwd(const float* q, const float* k, const float* v, float* o, const Dims& t,
               const FwdPlan& plan, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<VW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwd_kernel<VW>, kFwdThreads,
                                                         plan.smem)) != cudaSuccess)
    return (int)e;
  // persistent: as many blocks as are resident at once, at most one a
  // whole tile, at least one (for the ragged tile)
  const long long whole = t.b / plan.tile;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  grid = grid < whole ? grid : whole;
  grid = grid < 1 ? 1 : grid;
  fwd_kernel<VW><<<(unsigned)grid, kFwdThreads, plan.smem, stream>>>(q, k, v, o, t, plan.tile,
                                                                     plan.stages);
  return (int)cudaGetLastError();
}

}  // namespace ta
}  // namespace ufo

// Both return a cudaError_t value (0 on success): cudaErrorInvalidValue for
// L or S outside 1..8, D or M outside 1..16, or rows that do not fit in
// shared memory. Tensors are contiguous float32; the forward's start on
// 16-byte boundaries.
extern "C" int ufo_tiny_attention_fwd(const float* q, const float* k, const float* v,
                                      float* o, int b, int l, int s, int h, int d,
                                      int m, void* stream) {
  using namespace ufo::ta;
  const Dims t{b, l, s, h, d, m};
  if (!dims_ok(t)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const FwdPlan plan = fwd_plan(t);
  if (plan.tile == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // q/k and v/out rows read and written in float4, float2 or float pieces
  if (d % 4 == 0 && m % 4 == 0) return launch_fwd<4>(q, k, v, o, t, plan, st);
  if (d % 2 == 0 && m % 2 == 0) return launch_fwd<2>(q, k, v, o, t, plan, st);
  return launch_fwd<1>(q, k, v, o, t, plan, st);
}

extern "C" int ufo_tiny_attention_bwd(const float* q, const float* k, const float* v,
                                      const float* g, float* dq, float* dk, float* dv,
                                      int b, int l, int s, int h, int d, int m,
                                      void* stream) {
  const ufo::ta::Dims t{b, l, s, h, d, m};
  return ufo::ta::launch_bwd(q, k, v, g, dq, dk, dv, t, static_cast<cudaStream_t>(stream));
}
