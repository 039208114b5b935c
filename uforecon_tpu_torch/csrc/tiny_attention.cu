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
// Backward design: the forward's stream with a fourth input. At route A's
// shape a point reads q, k, v and g (4 x 320 floats) and writes dq, dk and
// dv (3 x 320) for ~6k FLOP, so bytes bound it too (0.175 ms at B =
// 65,536). Persistent blocks walk over tiles of points; the four input
// tiles arrive by 1-D TMA bulk copies into a ring of two stages, phi is
// applied to q and k once per stage in place (dphi(x) = min(phi(x), 1)
// needs nothing else), and dq, dk and dv go into one of two shared output
// tiles that leave by three bulk stores while the next tile computes. The
// sums over the L query tokens (dk and dv) and over the S source tokens
// (dq) run in two phases with one barrier between them, so no shared
// value is read, modified and written: phase 1 takes one (point, l, h)
// item a thread (the forward's mapping), recomputes the scores, the
// denominator and g . out, writes dq, and leaves sc / den and ds for each
// s in a scratch row of the point; phase 2 takes one (point, s, h) item a
// thread and sums those rows over l into dk and dv. Both phases read and
// write their rows as consecutive runs (float4, float2 or float pieces, as
// in the forward). The backward is built for bounds on the shape known
// when compiled (4, 6 or 8 tokens; 8, 10 or 16 channels), so its unrolled
// loops issue no step past L, S, D and M: with the forward's runtime
// bounds (8 and 16) half of its issue slots at route A's shape were
// predicated off, and its arithmetic, not its copies, set its time. The
// tile is the one that keeps the most items resident on an SM by shared
// memory: 4 points (128 items, 76,304 bytes, three blocks an SM) at route
// A's shape, 1 point at L = S = 6. (On the H100, timed with
// script/head_variants.py: the runtime bounds took 0.324 ms at route A's
// shape, these 0.207 ms, the copies alone 0.207 ms.) Bulk copies need
// 16-byte addresses and sizes, as in the forward: aligned tensors from the
// wrapper, tiles of a multiple of 4 points where a row needs it, and the
// ragged last tile loaded and stored element by element.
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

// n <= N floats from shared memory into r[0, n), zero past n; VW floats a
// load
template <int VW, int N>
__device__ __forceinline__ void load_row(float (&r)[N], const float* src, int n) {
#pragma unroll
  for (int i = 0; i < N; i += VW) {
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

template <int VW, int N>
__device__ __forceinline__ void store_row(float* dst, const float (&r)[N], int n) {
#pragma unroll
  for (int i = 0; i < N; i += VW) {
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

// ---- backward: persistent blocks fed by TMA bulk copies ----

constexpr int kBwdThreads = 128;   // at most; fewer when a tile has fewer items
constexpr int kBwdItems = 128;     // items of the larger phase a tile holds at most
constexpr int kBwdStages = 2;      // input stages in the ring
constexpr int kBwdMaxTile = 64;
constexpr int kSmemPerSm = 233472;   // an SM's shared memory
constexpr int kSmemPerBlock = 1024;  // the runtime's share of it for each block

// A scratch row of the backward: one source token s of a point, holding
// sc / den, then ds, of each of its L H (query token, head) items, padded
// by H floats so that the second phase reads it conflict-free at L H = 32.
__host__ __device__ inline int scratch_row(const Dims& t) { return 2 * t.l * t.h + t.h; }

// A backward tile: points, input stages, threads and shared bytes (0 points
// when the smallest tile does not fit). Of the tiles of at most kBwdItems
// items, the one that keeps the most items resident on an SM by its shared
// memory, ties to the larger tile: 4 points (128 items, three blocks) at
// L = S = 4, H = 8, D = M = 10; 1 point (48 items, seven blocks) at L = S = 6.
struct BwdPlan {
  int tile, stages, threads;
  size_t smem;
};

inline BwdPlan bwd_plan(const Dims& t) {
  const int rq = t.l * t.h * t.d, rk = t.s * t.h * t.d;
  const int rv = t.s * t.h * t.m, rg = t.l * t.h * t.m;
  // tiles hold a multiple of g points, so that every tile is a multiple
  // of 16 bytes
  int g = 1;
  for (int r : {rq, rk, rv, rg})
    while ((g * r) % 4) g *= 2;
  // ring of stages x [Q | K | V | G], two output tiles [dQ | dK | dV],
  // the barriers, then the scratch, S rows a point
  auto bytes = [&](int tile) {
    return sizeof(float) * (size_t)tile *
               ((size_t)kBwdStages * (rq + rk + rv + rg) + 2 * (size_t)(rq + rk + rv) +
                (size_t)t.s * scratch_row(t)) +
           sizeof(unsigned long long) * kBwdStages;
  };
  const int items = (t.l > t.s ? t.l : t.s) * t.h;   // a point's, in the larger phase
  auto threads = [&](int tile) {
    const int n = (tile * items + 31) / 32 * 32;
    return n < kBwdThreads ? n : kBwdThreads;
  };
  BwdPlan best{0, 0, 0, 0};
  long long best_items = 0;
  for (int tile = g; tile <= kBwdMaxTile && (tile == g || tile * items <= kBwdItems);
       tile += g) {
    if (bytes(tile) > (size_t)kSmemMax) break;
    long long blocks = kSmemPerSm / (long long)(bytes(tile) + kSmemPerBlock);
    const long long by_threads = 2048 / threads(tile);
    blocks = blocks < by_threads ? blocks : by_threads;
    blocks = blocks < 32 ? blocks : 32;
    const long long resident = blocks * tile * items;
    if (resident >= best_items) {   // ties to the larger tile: fewer barriers a point
      best = {tile, kBwdStages, threads(tile), bytes(tile)};
      best_items = resident;
    }
  }
  return best;
}

// Phase 1 of the backward over n points in shared memory, one (p, l, h)
// item idx = (p L + l) H + h a thread, from Q = phi(q), K = phi(k), V and
// G: the scores, the denominator and the output recomputed, then for each
// source token s, into the point's scratch row s,
//   W[s][l H + h] = sc / den,   W[s][L H + l H + h] = ds = (g . v_s - g . out) / den,
// and dq = sum_s ds K_s * dphi(q) into DQ,
// with dphi(x) = min(phi(x), 1). The S scores are independent dot products,
// taken first; sums over s run in order. L, S <= NT and D, M <= ND.
template <int VW, int NT, int ND>
__device__ __forceinline__ void bwd_items(const float* Q, const float* K, const float* V,
                                          const float* G, float* W, float* DQ, const Dims& t,
                                          int n) {
  const int H = t.h, D = t.d, M = t.m, LH = t.l * H, SW = scratch_row(t);
  for (int idx = threadIdx.x; idx < n * LH; idx += blockDim.x) {
    const int p = idx / LH, lh = idx - p * LH, h = lh % H;
    const float* kp = K + ((size_t)p * t.s * H + h) * D;   // k[p, s, h] at kp + s H D
    const float* vp = V + ((size_t)p * t.s * H + h) * M;
    float qf[ND], gl[ND], row[ND], acc[ND], sc[NT], gv[NT];
    load_row<VW>(qf, Q + (size_t)idx * D, D);
    load_row<VW>(gl, G + (size_t)idx * M, M);
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      sc[s] = 0.f;
      if (s < t.s) {
        load_row<VW>(row, kp + (size_t)s * H * D, D);
#pragma unroll
        for (int d = 0; d < ND; ++d)
          if (d < D) sc[s] = fmaf(qf[d], row[d], sc[s]);
      }
    }
    float den = 0.f;
#pragma unroll
    for (int s = 0; s < NT; ++s)
      if (s < t.s) den += sc[s];
    den += kAttnEps;
    const float inv = 1.f / den;
    // the output's numerator and g . v_s, from one read of each v row
#pragma unroll
    for (int m = 0; m < ND; ++m) acc[m] = 0.f;
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      gv[s] = 0.f;
      if (s < t.s) {
        load_row<VW>(row, vp + (size_t)s * H * M, M);
#pragma unroll
        for (int m = 0; m < ND; ++m)
          if (m < M) {
            acc[m] = fmaf(sc[s], row[m], acc[m]);
            gv[s] = fmaf(gl[m], row[m], gv[s]);
          }
      }
    }
    float go = 0.f;
#pragma unroll
    for (int m = 0; m < ND; ++m)
      if (m < M) go = fmaf(gl[m], acc[m] * inv, go);
    float* wp = W + (size_t)p * t.s * SW + lh;   // W[p][s][lh] at wp + s SW
    float* dp = wp + LH;
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[d] = 0.f;
#pragma unroll
    for (int s = 0; s < NT; ++s) {
      if (s < t.s) {
        const float ds = (gv[s] - go) * inv;
        wp[s * SW] = sc[s] * inv;
        dp[s * SW] = ds;
        load_row<VW>(row, kp + (size_t)s * H * D, D);
#pragma unroll
        for (int d = 0; d < ND; ++d)
          if (d < D) acc[d] = fmaf(ds, row[d], acc[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < ND; ++d) acc[d] *= fminf(qf[d], 1.f);
    store_row<VW>(DQ + (size_t)idx * D, acc, D);
  }
}

// Phase 2: one (p, s, h) item idx = (p S + s) H + h a thread sums its
// point's L query tokens in order, from the scratch row phase 1 wrote:
//   dv = sum_l W[s][l H + h] g_l,   dk = sum_l W[s][L H + l H + h] Q_l * dphi(k),
// so the sums over l need no shared-memory read-modify-write.
template <int VW, int NT, int ND>
__device__ __forceinline__ void bwd_sources(const float* Q, const float* K, const float* G,
                                            const float* W, float* DK, float* DV,
                                            const Dims& t, int n) {
  const int H = t.h, D = t.d, M = t.m, SH = t.s * H, SW = scratch_row(t);
  for (int idx = threadIdx.x; idx < n * SH; idx += blockDim.x) {
    const int p = idx / SH, sh = idx - p * SH, s = sh / H, h = sh - s * H;
    const float* qp = Q + ((size_t)p * t.l * H + h) * D;   // q[p, l, h] at qp + l H D
    const float* gp = G + ((size_t)p * t.l * H + h) * M;
    const float* wp = W + ((size_t)p * t.s + s) * SW + h;  // W[p][s][l H + h] at wp + l H
    const float* dp = wp + t.l * H;
    float dk[ND], dv[ND], row[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) dk[d] = dv[d] = 0.f;
#pragma unroll
    for (int l = 0; l < NT; ++l) {
      if (l < t.l) {
        const float w = wp[l * H], ds = dp[l * H];
        load_row<VW>(row, gp + (size_t)l * H * M, M);
#pragma unroll
        for (int m = 0; m < ND; ++m)
          if (m < M) dv[m] = fmaf(w, row[m], dv[m]);
        load_row<VW>(row, qp + (size_t)l * H * D, D);
#pragma unroll
        for (int d = 0; d < ND; ++d)
          if (d < D) dk[d] = fmaf(ds, row[d], dk[d]);
      }
    }
    load_row<VW>(row, K + (size_t)idx * D, D);
#pragma unroll
    for (int d = 0; d < ND; ++d) dk[d] *= fminf(row[d], 1.f);
    store_row<VW>(DK + (size_t)idx * D, dk, D);
    store_row<VW>(DV + (size_t)idx * M, dv, M);
  }
}

// The two phases over n points, by every thread of the block.
template <int VW, int NT, int ND>
__device__ __forceinline__ void backprop(const float* Q, const float* K, const float* V,
                                         const float* G, float* W, float* DQ, float* DK,
                                         float* DV, const Dims& t, int n) {
  bwd_items<VW, NT, ND>(Q, K, V, G, W, DQ, t, n);
  __syncthreads();
  bwd_sources<VW, NT, ND>(Q, K, G, W, DK, DV, t, n);
}

template <int VW, int NT, int ND>
__global__ void __launch_bounds__(kBwdThreads, 3) bwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v,
    const float* __restrict__ g,   // (B, L, H, M) gradient of the output
    float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    Dims t, int tile, int stages) {
  extern __shared__ float4 smem4[];
  const int rq = t.l * t.h * t.d, rk = t.s * t.h * t.d;
  const int rv = t.s * t.h * t.m, rg = t.l * t.h * t.m;
  const int stage_floats = tile * (rq + rk + rv + rg);
  const int out_floats = tile * (rq + rk + rv);
  float* ring = reinterpret_cast<float*>(smem4);       // stages x [Q | K | V | G]
  float* obuf = ring + stages * stage_floats;          // 2 x [dQ | dK | dV]
  auto* full = reinterpret_cast<unsigned long long*>(obuf + 2 * out_floats);
  float* W = reinterpret_cast<float*>(full + stages);  // tile x S scratch rows
  const int tid = threadIdx.x;
  const int nfull = t.b / tile;                        // whole tiles
  // this block's whole tiles: blockIdx.x + i gridDim.x, i < mine
  const int mine = (int)blockIdx.x < nfull ? (nfull - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const uint32_t bq = 4u * tile * rq, bk = 4u * tile * rk, bv = 4u * tile * rv,
                 bg = 4u * tile * rg;

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
    mbar_expect(full + s, bq + bk + bv + bg);
    bulk_load(Qs, q + p0 * rq, bq, full + s);
    bulk_load(Qs + tile * rq, k + p0 * rk, bk, full + s);
    bulk_load(Qs + tile * (rq + rk), v + p0 * rv, bv, full + s);
    bulk_load(Qs + tile * (rq + rk + rv), g + p0 * rg, bg, full + s);
  };
  if (tid == 0)
    for (int i = 0; i < stages && i < mine; ++i) fetch(i);

  for (int i = 0; i < mine; ++i) {
    const int s = i % stages;
    float* Qs = ring + s * stage_floats;
    float* Ks = Qs + tile * rq;
    float* Vs = Ks + tile * rk;
    float* Gs = Vs + tile * rv;
    float* Os = obuf + (i & 1) * out_floats;
    mbar_wait(full + s, (i / stages) & 1);
    // the three stores of tile i - 2 are done reading Os
    if (tid == 0) bulk_wait_read<3>();
    // phi of q and k, once per stage, in place (Q and K are adjacent)
    float4* QK4 = reinterpret_cast<float4*>(Qs);
    for (int j = tid; j < tile * (rq + rk) / 4; j += blockDim.x) {
      const float4 x = QK4[j];
      QK4[j] = make_float4(phi(x.x), phi(x.y), phi(x.z), phi(x.w));
    }
    __syncthreads();
    backprop<VW, NT, ND>(Qs, Ks, Vs, Gs, W, Os, Os + tile * rq, Os + tile * (rq + rk), t, tile);
    fence_async_shared();
    // Os is whole and the stage is free
    __syncthreads();
    if (tid == 0) {
      const size_t p0 = (size_t)(blockIdx.x + (size_t)i * gridDim.x) * tile;
      bulk_store(dq + p0 * rq, Os, bq);
      bulk_store(dk + p0 * rk, Os + tile * rq, bk);
      bulk_store(dv + p0 * rv, Os + tile * (rq + rk), bv);
      if (i + stages < mine) fetch(i + stages);
    }
  }

  // the ragged last tile, element by element, by the block whose turn it is
  const int n = t.b - nfull * tile;
  if (n > 0 && (int)blockIdx.x == nfull % (int)gridDim.x) {
    float* Qs = ring;
    float* Ks = Qs + tile * rq;
    float* Vs = Ks + tile * rk;
    float* Gs = Vs + tile * rv;
    float *DQ = obuf, *DK = DQ + tile * rq, *DV = DK + tile * rk;
    const size_t p0 = (size_t)nfull * tile;
    if (tid == 0) bulk_wait_read<0>();
    for (int j = tid; j < n * rq; j += blockDim.x) Qs[j] = phi(q[p0 * rq + j]);
    for (int j = tid; j < n * rk; j += blockDim.x) Ks[j] = phi(k[p0 * rk + j]);
    for (int j = tid; j < n * rv; j += blockDim.x) Vs[j] = v[p0 * rv + j];
    for (int j = tid; j < n * rg; j += blockDim.x) Gs[j] = g[p0 * rg + j];
    __syncthreads();
    backprop<VW, NT, ND>(Qs, Ks, Vs, Gs, W, DQ, DK, DV, t, n);
    __syncthreads();
    for (int j = tid; j < n * rq; j += blockDim.x) dq[p0 * rq + j] = DQ[j];
    for (int j = tid; j < n * rk; j += blockDim.x) dk[p0 * rk + j] = DK[j];
    for (int j = tid; j < n * rv; j += blockDim.x) dv[p0 * rv + j] = DV[j];
  }
  if (tid == 0) bulk_wait_all();
}

inline bool dims_ok(const Dims& t) {
  return t.b >= 0 && t.l >= 1 && t.l <= kMaxLen && t.s >= 1 && t.s <= kMaxLen &&
         t.h >= 1 && t.d >= 1 && t.d <= kMaxDim && t.m >= 1 && t.m <= kMaxDim;
}

// Persistent grid of `kernel` at this block size and shared memory: as many
// blocks as are resident at once, at most one a whole tile, at least one
// (for the ragged tile). Returns a cudaError_t value.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, long long whole,
                    unsigned* grid) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)e;
  long long n = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  n = n < whole ? n : whole;
  *grid = (unsigned)(n < 1 ? 1 : n);
  return 0;
}

template <int VW, int NT, int ND>
int launch_bwd(const float* q, const float* k, const float* v, const float* g, float* dq,
               float* dk, float* dv, const Dims& t, const BwdPlan& plan,
               cudaStream_t stream) {
  unsigned grid = 0;
  const int e = persistent_grid(bwd_kernel<VW, NT, ND>, plan.threads, plan.smem,
                                t.b / plan.tile, &grid);
  if (e) return e;
  bwd_kernel<VW, NT, ND><<<grid, plan.threads, plan.smem, stream>>>(
      q, k, v, g, dq, dk, dv, t, plan.tile, plan.stages);
  return (int)cudaGetLastError();
}

// The backward built for the shape: the smallest of 4, 6 and 8 tokens that
// holds L and S, and of 8, 10 (rows read in pieces of one or two floats)
// and 16 channels that holds D and M, so that its unrolled loops run no
// step past the shape.
template <int VW, int NT>
int launch_bwd_dims(const float* q, const float* k, const float* v, const float* g,
                    float* dq, float* dk, float* dv, const Dims& t, const BwdPlan& plan,
                    cudaStream_t stream) {
  if (t.d <= 8 && t.m <= 8) return launch_bwd<VW, NT, 8>(q, k, v, g, dq, dk, dv, t, plan, stream);
  if constexpr (VW != 4)
    if (t.d <= 10 && t.m <= 10)
      return launch_bwd<VW, NT, 10>(q, k, v, g, dq, dk, dv, t, plan, stream);
  return launch_bwd<VW, NT, kMaxDim>(q, k, v, g, dq, dk, dv, t, plan, stream);
}

template <int VW>
int launch_bwd_tokens(const float* q, const float* k, const float* v, const float* g,
                      float* dq, float* dk, float* dv, const Dims& t, const BwdPlan& plan,
                      cudaStream_t stream) {
  if (t.l <= 4 && t.s <= 4)
    return launch_bwd_dims<VW, 4>(q, k, v, g, dq, dk, dv, t, plan, stream);
  if (t.l <= 6 && t.s <= 6)
    return launch_bwd_dims<VW, 6>(q, k, v, g, dq, dk, dv, t, plan, stream);
  return launch_bwd_dims<VW, kMaxLen>(q, k, v, g, dq, dk, dv, t, plan, stream);
}

template <int VW>
int launch_fwd(const float* q, const float* k, const float* v, float* o, const Dims& t,
               const FwdPlan& plan, cudaStream_t stream) {
  unsigned grid = 0;
  const int e = persistent_grid(fwd_kernel<VW>, kFwdThreads, plan.smem, t.b / plan.tile, &grid);
  if (e) return e;
  fwd_kernel<VW><<<grid, kFwdThreads, plan.smem, stream>>>(q, k, v, o, t, plan.tile,
                                                           plan.stages);
  return (int)cudaGetLastError();
}

}  // namespace ta
}  // namespace ufo

// Both return a cudaError_t value (0 on success): cudaErrorInvalidValue for
// L or S outside 1..8, D or M outside 1..16, or rows that do not fit in
// shared memory. Tensors are contiguous float32 starting on 16-byte
// boundaries (TMA bulk copies).
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
  using namespace ufo::ta;
  const Dims t{b, l, s, h, d, m};
  if (!dims_ok(t)) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const BwdPlan plan = bwd_plan(t);
  if (plan.tile == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && m % 4 == 0)
    return launch_bwd_tokens<4>(q, k, v, g, dq, dk, dv, t, plan, st);
  if (d % 2 == 0 && m % 2 == 0)
    return launch_bwd_tokens<2>(q, k, v, g, dq, dk, dv, t, plan, st);
  return launch_bwd_tokens<1>(q, k, v, g, dq, dk, dv, t, plan, st);
}
