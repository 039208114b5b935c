// Fused along-ray SRDF head for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ray_head_fused (body _kernel) of the
// JAX package's ops/fused_ray_head.py. Per ray, over its SN z-sorted tokens of
// C channels (the view-token features | 8 order PE):
//   * one LoFTR layer with elu+1 linear attention ACROSS the samples,
//     8 heads x C/8, LayerNorm(eps 1e-6), mlp 2C -> 2C -> C, residual;
//   * density MLP C -> 32 -> 16 -> 1, giving the SRDF of each sample.
// Like the JAX kernel it takes any token width and any sample count: C is
// a runtime argument, any multiple of 8 up to 112 (every width a JAX flag
// set gives: 40 .. 112; 88 at the default configuration, 72 without
// explicit similarity, 112 with use_dir_srdf), and SN any count >= 1.
// Three widths are compiled: 88 and 72, whose offsets, strides and loop
// bounds fold to constants, and one runtime-width instantiation for every
// other C, whose register arrays (a warp's column tiles, a head's
// features, a LayerNorm lane's features) are sized for C = 112 and masked
// past C: 3 x kNeus x kFast = 12 instantiations, against 8 when the
// kernel took 88 and 72 alone. (C = 88 through the runtime-width
// instantiation measured 0.738 + 0.913 ms at SN 64 + 128 on an H100, 23 %
// over the 1.343 ms of the width compiled in.)
//
// What bounds it on the H100: arithmetic, as for the point head. At C = 88
// a sample costs ~8.3e4 multiply-adds (the 88x88 and 176x176 layers)
// against 352 bytes in and 4 out, about 460 FLOP per byte.
//
// Design: one block of 512 threads per ray. The linear attention couples a
// ray's samples only through its state, the per-head key-value sums
// sum_s phi(k_s) v_s^T and key sums sum_s phi(k_s) (taken in kv order, so
// nothing SN x SN exists), so the ray is taken in tiles of ROWS samples
// (rows padded to whole m16 tiles, strides C + 4 / 2C + 4 floats against
// bank conflicts):
//   * phase 1, tile by tile: the tokens (cp.async), k and v, the state
//     summed over the tile's real samples in shared memory, each entry
//     in sample order;
//   * phase 2, tile by tile: q, the attention against the state, merge ->
//     LayerNorm -> mlp1 -> mlp2 -> LayerNorm + residual -> density MLP.
// Where the whole ray fits one tile (resident: ROWS = SN rounded up to 16,
// at most one m16 tile per warp; SN <= 128 at C = 88, <= 96 at C = 112)
// phase 2 reuses phase 1's tokens, as the kernel always did; a longer ray
// streams tiles of 128, 64, 32 or 16 rows (the largest that fits; row
// tiles that divide the 16 warps) and reads its tokens twice. Shared
// memory is ROWS x (4C + 12) floats + the state + the weight ring, so it
// depends on ROWS, not on SN: at C = 112, SN = 128 two tiles of 64 take
// 154,176 bytes where one resident tile would need 271,936 (Hopper allows
// 232,448). The q/k/v/merge, mlp1 and mlp2 layers run on the tensor cores
// in 3xTF32 (tc_gemm.cuh), their hi/lo weight planes (pre-split on the
// host) streamed through a two-slot cp.async ring. The LayerNorms
// (tc::layernorm_n), the attention and the density MLP (common.cuh's
// block_gemm) stay FP32 on the CUDA cores.
//
// What bounded it at C = 88 (H100, 1024 rays, variants timed apart, when
// C was a template parameter): of ~0.58 / ~0.72 ms at SN = 64 / 128,
// ~0.13 / ~0.22 ms is outside the tensor-core layers (the density MLP,
// the LayerNorms, the kv state and the attention, latency-bound between
// block-wide syncs), the products take ~0.25 ms and the operand split,
// fragment loads and the per-step sync the rest; a third ring slot and
// 256 threads measured slower.
//
// NeuS epilogue (kNeus = true) replaces ray_head_neus_fused (body
// _kernel_neus / _neus_epilogue) of the same JAX file: once the ray's SN
// srdf values are in shared memory, the block composites the ray as
// ops/rendering.py neus_render does (midpoint intervals, sigmoid CDFs at
// srdf +- 0.75 interval, clipped alpha, exclusive product of
// 1 - alpha + 1e-7, weights, rgb / depth / opacity), with z and radiance
// read from global memory. It needs 5 * SN floats: a resident ray reuses
// the dead hidden-layer buffer, a streamed one takes them after the ring
// (20 KB at SN = 1024). The product runs serially in one thread, in
// torch.cumprod's CPU order; the JAX kernel's 0/1 matmuls and log-space
// cumprod were MXU devices. At SN = 1 neus_render has no interval: its
// weights are empty and its sums 0, and so are the kernel's.
//
// kFast (kernel_precision 'fast'): the JAX kernel's single bf16 pass at
// its kernel_dot sites (fused_ray_head.py:85-87, 108-113): the layer
// products (q/k/v, merge, mlp1, mlp2 on tc_gemm.cuh's bf16 mma.m16n8k16,
// the density MLP as block_gemm's FP32 FMAs of bf16-rounded operands) and
// the attention sums kv = sum_s phi(k_s) v_s^T, num = phi(q) kv and den =
// phi(q) ksum, each with both operands rounded to bf16 and the products
// summed in FP32 (ksum itself an FP32 sum). The NeuS epilogue does not
// depend on it, as in JAX. In 'fast' the widths 40 .. 112 run
// ray_head_fast.cuh (the same function, designed for bf16: resident
// weights, persistent blocks, the chain in registers); the kFast
// instantiations here take only the widths below 40, which no JAX flag set
// gives (ops/fused_ray_head.py FAST_WIDTHS, takes_fast_kernel), and at 40 ..
// 112 are reached only by script/head_variants.py's rh,fast and the GPU
// tests' bit-for-bit comparison (test_torch_port_ray_head_fast.py).
#include "common.cuh"
#include "tc_gemm.cuh"

namespace ufo {
namespace rh {

constexpr int NH = 8;       // heads
constexpr int D0 = 32, D1 = 16;
constexpr int kCMax = 112;  // widest token width

__host__ __device__ inline bool width_ok(int c) {
  return c > 0 && c % 8 == 0 && c <= kCMax;   // 8 heads, n8 tiles
}

// Widths of the token-width-C kernel and the offsets into its packed weight
// buffer, matrices in (in, out) orientation, the tensor-core matrices as a
// TF32 hi plane followed by its lo plane. C % 8 == 0 keeps the weight
// planes, the state and the ring 16-byte aligned.
struct Layout {
  int C, C2, DK, LD, LD2;
  int o_wq, o_wk, o_wv, o_wm, o_n1s, o_n1b, o_w1, o_w2, o_n2s, o_n2b;
  int o_dw0, o_db0, o_dw1, o_db1, o_dw2, o_db2, n_w, state;
  __host__ __device__ explicit Layout(int c)
      : C(c), C2(2 * c), DK(c / NH), LD(tc::act_ld(c)), LD2(tc::act_ld(2 * c)) {
    o_wq = 0;
    o_wk = o_wq + 2 * C * C;
    o_wv = o_wk + 2 * C * C;
    o_wm = o_wv + 2 * C * C;
    o_n1s = o_wm + 2 * C * C;
    o_n1b = o_n1s + C;
    o_w1 = o_n1b + C;
    o_w2 = o_w1 + 2 * C2 * C2;
    o_n2s = o_w2 + 2 * C2 * C;
    o_n2b = o_n2s + C;
    o_dw0 = o_n2b + C;
    o_db0 = o_dw0 + C * D0;
    o_dw1 = o_db0 + D0;
    o_db1 = o_dw1 + D0 * D1;
    o_dw2 = o_db1 + D1;
    o_db2 = o_dw2 + D1;
    n_w = o_db2 + 1;
    state = NH * DK * DK + C;   // key-value sums, then key sums
  }
};

// 512 threads: at SN = 128 a block's shared memory leaves room for one
// block per SM, so the block itself must bring the warps
constexpr int kRayThreads = 512;
constexpr int kWarps = kRayThreads / 32;
constexpr int kStages = 2;   // weight ring slots
constexpr int kTileMax = 128;  // rows of a streamed tile, at most

__host__ __device__ inline int padded_rows(int sn) { return (sn + 15) & ~15; }

// Shared memory of a block with tiles of `rows` and `extra` floats more.
inline size_t smem_bytes(int rows, int c, int extra) {
  const Layout L(c);
  return sizeof(float) * ((size_t)rows * (2 * L.LD + L.LD2) + L.state +
                          tc::ring_floats(kStages, L.C2) + extra);
}

// Tile rows for a ray of sn samples on a card that gives a block `limit`
// bytes: the whole ray (resident) where it fits one tile of at most one m16
// tile per warp, else the largest streamed tile of 128, 64, 32 or 16 rows
// (a NeuS ray then keeps its 5 sn floats beside the tiles); 0 if none fits.
inline int tile_rows(int sn, int c, bool neus, size_t limit) {
  const int snp = padded_rows(sn);
  if (snp <= 16 * kWarps && smem_bytes(snp, c, 0) <= limit) return snp;
  for (int rows = kTileMax; rows >= 16; rows /= 2)
    if (smem_bytes(rows, c, neus ? 5 * sn : 0) <= limit) return rows;
  return 0;
}

inline size_t plan_bytes(int sn, int c, bool neus, size_t limit, int rows) {
  const bool streamed = (sn + rows - 1) / rows > 1;
  return smem_bytes(rows, c, neus && streamed ? 5 * sn : 0);
}

// `rows` tokens of width C from global src (16-byte aligned rows) into X
// (stride ld) by cp.async, rows up to prows zero. Ends in __syncthreads().
__device__ void load_tokens(float* X, int ld, const float* __restrict__ src, int rows,
                            int prows, int C) {
  const int c4 = C / 4;
  for (int i = threadIdx.x; i < rows * c4; i += blockDim.x) {
    const int s = i / c4, j = i - s * c4;
    tc::cp_async16(X + s * ld + 4 * j, src + s * C + 4 * j);
  }
  tc::cp_async_commit();
  for (int i = threadIdx.x; i < (prows - rows) * C; i += blockDim.x)
    X[(rows + i / C) * ld + i % C] = 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();
}

// NeuS compositing of one ray whose srdf values are in S (shared, SN
// floats); T is shared scratch of 4 * SN floats. Mirrors neus_render at
// cos_anneal_ratio 1: next / prev srdf = srdf -/+ 0.75 * interval.
__device__ void neus_epilogue(const float* S, float* T, int SN,
                              const float* __restrict__ z,    // (SN,)
                              const float* __restrict__ rad,  // (SN, 3)
                              float inv_s, float* __restrict__ weight,
                              float* __restrict__ rgb, float* __restrict__ depth,
                              float* __restrict__ opacity) {
  const int tid = threadIdx.x;
  if (SN < 2) {   // no interval: empty weights, zero sums, as neus_render
    if (tid < 3) rgb[tid] = 0.f;
    else if (tid == 3) *depth = 0.f;
    else if (tid == 4) *opacity = 0.f;
    return;
  }
  float* Z = T;               // z
  float* F = T + SN;          // alpha, later 1 - alpha + 1e-7
  float* TR = T + 2 * SN;     // exclusive product (transmittance)
  float* WT = T + 3 * SN;     // weight
  for (int s = tid; s < SN; s += blockDim.x) Z[s] = z[s];
  __syncthreads();
  for (int s = tid; s < SN; s += blockDim.x) {
    // neus_render pads the SN - 1 intervals with their first and last and
    // averages neighbours: mid[s] = (iv[max(s-1, 0)] + iv[min(s, SN-2)]) / 2
    const int j0 = s > 0 ? s - 1 : 0;
    const int j1 = s < SN - 2 ? s : SN - 2;
    const float mid = ((Z[j0 + 1] - Z[j0]) + (Z[j1 + 1] - Z[j1])) * 0.5f;
    const float half = (-1.5f * mid) * 0.5f;   // iter_cos * interval * 0.5
    const float next_cdf = 1.f / (1.f + expf(-((S[s] + half) * inv_s)));
    const float prev_cdf = 1.f / (1.f + expf(-((S[s] - half) * inv_s)));
    const float a = fminf(fmaxf(((prev_cdf - next_cdf) + 1e-5f) / (prev_cdf + 1e-5f),
                                0.f), 1.f);
    WT[s] = a;
    F[s] = (1.f - a) + 1e-7f;
  }
  __syncthreads();
  if (tid == 0) {
    float t = 1.f;
    for (int s = 0; s < SN; ++s) {
      TR[s] = t;
      t *= F[s];
    }
  }
  __syncthreads();
  for (int s = tid; s < SN; s += blockDim.x) {
    WT[s] *= TR[s];
    weight[s] = WT[s];
  }
  __syncthreads();
  // five sums over the samples, one warp each: rgb (3), depth, opacity
  const int wid = tid >> 5, lane = tid & 31;
  if (wid < 5) {
    float acc = 0.f;
    for (int s = lane; s < SN; s += 32)
      acc += WT[s] * (wid < 3 ? __ldg(rad + s * 3 + wid) : wid == 3 ? Z[s] : 1.f);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (wid < 3) rgb[wid] = acc;
      else if (wid == 3) *depth = acc;
      else *opacity = acc;
    }
  }
}

// Outputs of the NeuS epilogue, all null when kNeus is false.
struct NeusArgs {
  const float* z;      // (RN, SN)
  const float* rad;    // (RN, SN, 3)
  const float* inv_s;  // () on the device, clamped here to [1e-6, 1e6]
  float* weight;       // (RN, SN)
  float* rgb;          // (RN, 3)
  float* depth;        // (RN,)
  float* opacity;      // (RN,)
};

// CT: the token width when it is compiled in (the main paths' 88 and 72,
// whose offsets, strides and loops then fold to constants), or 0 for any
// width up to kCMax, read from C_arg
template <int CT, bool kNeus, bool kFast>
__global__ void __launch_bounds__(kRayThreads) ray_head_kernel(
    const float* __restrict__ y,   // (RN, SN, C)
    const float* __restrict__ W,   // packed weights, Layout(C).n_w floats
    float* __restrict__ srdf,      // (RN, SN)
    int SN, int C_arg, int ROWS, NeusArgs nz) {
  constexpr int CMAX = CT > 0 ? CT : kCMax;
  const int C = CT > 0 ? CT : C_arg;
  constexpr int DKMAX = CMAX / NH;
  // column tiles of a warp's run: one pass over k for a 128-row tile
  constexpr int NT_C = tc::col_tiles(kWarps, kTileMax / 16, CMAX);
  constexpr int NT_C2 = tc::col_tiles(kWarps, kTileMax / 16, 2 * CMAX);
  const Layout L(C);
  const int C2 = L.C2, DK = L.DK, LD = L.LD, LD2 = L.LD2;
  const int tiles = (SN + ROWS - 1) / ROWS;
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // ROWS x LD  tokens, later the layer output
  float* A = X + ROWS * LD;        // ROWS x LD2  keys -> queries/attention -> mlp1
  float* B = A + ROWS * LD2;       // ROWS x LD   values -> message -> mlp2 out
  float* KV = B + ROWS * LD;       // NH x DK x DK: sum_s phi(k_s)[d] v_s[m]
  float* KS = KV + NH * DK * DK;   // C: sum_s phi(k_s)
  float* ring = KS + C;            // weight slots
  // NeuS: the ray's srdf (S) and 4 SN floats of scratch after it, in the
  // dead hidden-layer buffer of a resident ray, else after the ring
  float* S = tiles == 1 ? A : ring + tc::ring_floats(kStages, C2);
  const int tid = threadIdx.x;
  const size_t r = blockIdx.x;
  const float* yr = y + r * SN * C;

  for (int i = tid; i < L.state; i += blockDim.x) KV[i] = 0.f;   // KV, KS

  // phase 1: the attention state over the ray's samples, tile by tile;
  // each entry summed in sample order over the real samples only (in
  // kFast of bf16-rounded products, rounded once at the end, as the later
  // products take them)
  for (int t = 0; t < tiles; ++t) {
    const int s0 = t * ROWS, rows = min(ROWS, SN - s0), mtiles = padded_rows(rows) / 16;
    load_tokens(X, LD, yr + (size_t)s0 * C, rows, padded_rows(rows), C);
    // keys -> A, values -> B (each gemm ends in a block-wide sync)
    tc::gemm<kStages, NT_C, kFast>(X, LD, C, nullptr, 0, 0, W + L.o_wk, ring, A, LD,
                                   mtiles, C, tc::kPhi);
    tc::gemm<kStages, NT_C, kFast>(X, LD, C, nullptr, 0, 0, W + L.o_wv, ring, B, LD,
                                   mtiles, C, tc::kNone);
    for (int e = tid; e < NH * DK * DK; e += blockDim.x) {
      const int h = e / (DK * DK);
      const int d = (e / DK) % DK;
      const int m = e % DK;
      float acc = KV[e];
      for (int s = 0; s < rows; ++s) {
        const float k = A[s * LD + h * DK + d], v = B[s * LD + h * DK + m];
        acc = kFast ? fmaf(bf16_round(k), bf16_round(v), acc) : fmaf(k, v, acc);
      }
      KV[e] = acc;
    }
    for (int c = tid; c < C; c += blockDim.x) {
      float acc = KS[c];
      for (int s = 0; s < rows; ++s) acc += A[s * LD + c];
      KS[c] = acc;
    }
    __syncthreads();
  }
  if (kFast) {
    for (int i = tid; i < L.state; i += blockDim.x) KV[i] = bf16_round(KV[i]);
    __syncthreads();
  }

  // phase 2: the rest of the layer and the density MLP, tile by tile
  for (int t = 0; t < tiles; ++t) {
    const int s0 = t * ROWS, rows = min(ROWS, SN - s0), mtiles = padded_rows(rows) / 16;
    if (tiles > 1) load_tokens(X, LD, yr + (size_t)s0 * C, rows, padded_rows(rows), C);
    // queries -> A (keys are dead), attention output in place
    tc::gemm<kStages, NT_C, kFast>(X, LD, C, nullptr, 0, 0, W + L.o_wq, ring, A, LD,
                                   mtiles, C, tc::kNone);
    for (int e = tid; e < rows * NH; e += blockDim.x) {
      const int s = e / NH, h = e - (e / NH) * NH;
      float q[DKMAX];
      float den = 0.f;
#pragma unroll
      for (int d = 0; d < DKMAX; ++d) {
        if (d < DK) {
          q[d] = phi(A[s * LD + h * DK + d]);
          if (kFast) q[d] = bf16_round(q[d]);
          den = fmaf(q[d], KS[h * DK + d], den);
        }
      }
      den += kAttnEps;
      const float* kv = KV + h * DK * DK;
      float out[DKMAX];
#pragma unroll
      for (int m = 0; m < DKMAX; ++m) {
        if (m < DK) {
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < DKMAX; ++d)
            if (d < DK) acc = fmaf(q[d], kv[d * DK + m], acc);
          out[m] = acc / den;
        }
      }
#pragma unroll
      for (int m = 0; m < DKMAX; ++m)
        if (m < DK) A[s * LD + h * DK + m] = out[m];
    }
    __syncthreads();

    // merge + LayerNorm -> B (values are dead)
    tc::gemm<kStages, NT_C, kFast>(A, LD, C, nullptr, 0, 0, W + L.o_wm, ring, B, LD,
                                   mtiles, C, tc::kNone);
    tc::layernorm_n<CMAX>(B, LD, rows, C, W + L.o_n1s, W + L.o_n1b);
    // mlp1 over [tokens | message] -> A (ROWS x LD2)
    tc::gemm<kStages, NT_C2, kFast>(X, LD, C, B, LD, C, W + L.o_w1, ring, A, LD2, mtiles,
                                    C2, tc::kRelu);
    // mlp2 -> B, LayerNorm added into X (the residual)
    tc::gemm<kStages, NT_C, kFast>(A, LD2, C2, nullptr, 0, 0, W + L.o_w2, ring, B, LD,
                                   mtiles, C, tc::kNone);
    tc::layernorm_n<CMAX>(B, LD, rows, C, W + L.o_n2s, W + L.o_n2b, X, LD);

    // density MLP: C -> 32 -> 16 -> 1 (rows past the real ones, up to a
    // multiple of 4, are finite and go nowhere)
    const int rows4 = (rows + 3) & ~3;
    block_linear<4, kFast>(X, LD, C, W + L.o_dw0, W + L.o_db0, A, D0, rows4, D0, true);
    __syncthreads();
    block_linear<4, kFast>(A, D0, D0, W + L.o_dw1, W + L.o_db1, B, D1, rows4, D1, true);
    __syncthreads();
    // srdf of the tile's samples: to global, or (NeuS) to S (A is dead)
    block_linear<1, kFast>(B, D1, D1, W + L.o_dw2, W + L.o_db2,
                           kNeus ? S + s0 : srdf + r * SN + s0, 1, rows, 1, false);
    __syncthreads();
  }
  if (!kNeus) return;
  for (int s = tid; s < SN; s += blockDim.x) srdf[r * SN + s] = S[s];
  const float inv_s = fminf(fmaxf(__ldg(nz.inv_s), 1e-6f), 1e6f);
  neus_epilogue(S, S + SN, SN, nz.z + r * SN, nz.rad + r * SN * 3, inv_s,
                nz.weight + r * SN, nz.rgb + r * 3, nz.depth + r, nz.opacity + r);
}

template <int CT, bool kNeus, bool kFast>
int launch_c(const float* y, const float* w, float* srdf, int rn, int sn, int c,
             int rows, size_t smem, NeusArgs nz, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(ray_head_kernel<CT, kNeus, kFast>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  ray_head_kernel<CT, kNeus, kFast><<<rn, kRayThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      y, w, srdf, sn, c, rows, nz);
  return (int)cudaGetLastError();
}

template <int CT, bool kNeus>
int launch_p(const float* y, const float* w, float* srdf, int rn, int sn, int c,
             int rows, size_t smem, bool fast, NeusArgs nz, void* stream) {
  return fast ? launch_c<CT, kNeus, true>(y, w, srdf, rn, sn, c, rows, smem, nz, stream)
              : launch_c<CT, kNeus, false>(y, w, srdf, rn, sn, c, rows, smem, nz, stream);
}

inline size_t device_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)limit;
}

// Any C that width_ok takes, any sn >= 1: 88 and 72 compiled in, every
// other width through the runtime-width instantiation.
template <bool kNeus>
int launch(const float* y, const float* w, float* srdf, int rn, int sn, int c,
           bool fast, NeusArgs nz, void* stream) {
  if (rn <= 0) return 0;
  if (sn <= 0 || !width_ok(c)) return (int)cudaErrorInvalidValue;
  const size_t limit = device_limit();
  const int rows = tile_rows(sn, c, kNeus, limit);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = plan_bytes(sn, c, kNeus, limit, rows);
  if (c == 88)
    return launch_p<88, kNeus>(y, w, srdf, rn, sn, c, rows, smem, fast, nz, stream);
  if (c == 72)
    return launch_p<72, kNeus>(y, w, srdf, rn, sn, c, rows, smem, fast, nz, stream);
  return launch_p<0, kNeus>(y, w, srdf, rn, sn, c, rows, smem, fast, nz, stream);
}

}  // namespace rh
}  // namespace ufo

// 0 for a token width the kernel does not take.
extern "C" int ufo_ray_head_weight_count(int c) {
  return ufo::rh::width_ok(c) ? ufo::rh::Layout(c).n_w : 0;
}

// The tile rows and shared-memory bytes of a ray of sn samples at width c
// on a card that gives a block `limit` bytes (rows 0: no tile fits).
extern "C" int ufo_ray_head_tile_rows(int sn, int c, int neus, long long limit) {
  if (sn <= 0 || !ufo::rh::width_ok(c)) return 0;
  return ufo::rh::tile_rows(sn, c, neus != 0, (size_t)limit);
}

extern "C" long long ufo_ray_head_smem_bytes(int sn, int c, int neus, long long limit) {
  const int rows = ufo_ray_head_tile_rows(sn, c, neus, limit);
  return rows == 0 ? -1
                   : (long long)ufo::rh::plan_bytes(sn, c, neus != 0, (size_t)limit, rows);
}

// Returns a cudaError_t value (0 on success). c, the token width: a multiple
// of 8 up to 112; sn >= 1; fast picks the bf16 instantiation (its pack holds
// bf16 planes).
extern "C" int ufo_ray_head(const float* y, const float* w, float* srdf,
                            int rn, int sn, int c, int fast, void* stream) {
  return ufo::rh::launch<false>(y, w, srdf, rn, sn, c, fast != 0, ufo::rh::NeusArgs{},
                                stream);
}

// The ray head with the NeuS epilogue; the same return, sn, c and fast rule.
extern "C" int ufo_ray_head_neus(const float* y, const float* w,
                                 const float* z, const float* rad,
                                 const float* inv_s, float* srdf, float* weight,
                                 float* rgb, float* depth, float* opacity,
                                 int rn, int sn, int c, int fast, void* stream) {
  return ufo::rh::launch<true>(
      y, w, srdf, rn, sn, c, fast != 0,
      ufo::rh::NeusArgs{z, rad, inv_s, weight, rgb, depth, opacity}, stream);
}
