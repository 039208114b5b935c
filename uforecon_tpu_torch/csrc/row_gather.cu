// Block-local row gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package's
// script/bench_tile_gather.py pallas_gather_probe (body kernel, in mk):
//   out[b * P + p, :] = src[b * V + idx[b * P + p], :]
// for blocks b of V = P source and output rows of 128 bf16 values (256
// bytes). The JAX probe has two forms, take_along_axis with int32 and with
// uint32 indices; both compute this gather, and this kernel reads the index
// as unsigned 32 bits, which serves both. An index outside [0, V) is
// clamped to the block's last row, so no read leaves the block.
//
// What bounds it on the H100: bytes. Every output row is written once, its
// index read once, and each distinct source row read at least once; there
// is no arithmetic. The TPU kernel stages each 1 MiB source block in VMEM;
// that block exceeds Hopper's shared memory (227 KB a block), so here the
// source rows come from L2 / HBM, where a block's repeated rows hit L2.
//
// Design: a row is 16 lanes x one 16-byte vector load and store; a warp
// moves two rows per step. Lane 0 of each half-warp reads the row's index
// and hands it to the other 15 lanes by a shuffle. Each half-warp carries
// kRowsInFlight rows at once (indices first, then all loads, then all
// stores) so that enough loads are in flight to cover the latency of HBM.
#include <cuda_runtime.h>

#include <cstdint>

namespace ufo {
namespace rg {

constexpr int kLanesPerRow = 16;                 // 16 x 16 B = one 128-wide bf16 row
constexpr int kThreads = 256;
constexpr int kRowsInFlight = 4;                 // rows per half-warp and step
constexpr int kRowBytes = kLanesPerRow * 16;

__global__ void __launch_bounds__(kThreads) row_gather_kernel(
    const uint4* __restrict__ src,       // (n_blocks * V, 16) 16-byte vectors
    const uint32_t* __restrict__ idx,    // (n_blocks * P,)
    uint4* __restrict__ out,             // (n_blocks * P, 16)
    long long rows, int v, int p) {
  const int lane = threadIdx.x & (kLanesPerRow - 1);
  const long long group = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / kLanesPerRow;
  const long long n_groups = (long long)gridDim.x * blockDim.x / kLanesPerRow;
  // a half-warp's shuffles stay within its 16 lanes
  const unsigned half = (threadIdx.x & 16) ? 0xffff0000u : 0x0000ffffu;
  for (long long base = group * kRowsInFlight; base < rows;
       base += n_groups * kRowsInFlight) {
    long long from[kRowsInFlight];
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j) {
      const long long r = base + j;
      uint32_t i = 0;
      if (lane == 0 && r < rows) i = __ldg(idx + r);
      i = __shfl_sync(half, i, 0, kLanesPerRow);
      if (i >= (uint32_t)v) i = v - 1;
      from[j] = (r / p) * v + i;
    }
    uint4 val[kRowsInFlight] = {};
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (base + j < rows) val[j] = __ldg(src + from[j] * kLanesPerRow + lane);
#pragma unroll
    for (int j = 0; j < kRowsInFlight; ++j)
      if (base + j < rows) out[(base + j) * kLanesPerRow + lane] = val[j];
  }
}

}  // namespace rg
}  // namespace ufo

extern "C" int ufo_row_gather_row_bytes() { return ufo::rg::kRowBytes; }

// src (n_blocks * v rows of 256 bytes), idx (n_blocks * p uint32 or int32),
// out (n_blocks * p rows). Returns a cudaError_t value (0 on success).
extern "C" int ufo_row_gather(const void* src, const void* idx, void* out,
                              long long n_blocks, int v, int p, void* stream) {
  using namespace ufo::rg;
  const long long rows = n_blocks * p;
  if (rows <= 0) return 0;
  if (v <= 0 || p <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // enough half-warps for every row in one step, at most 8 blocks per SM
  const long long per_block = (long long)kThreads / kLanesPerRow * kRowsInFlight;
  long long grid = (rows + per_block - 1) / per_block;
  if (grid > 8LL * sms) grid = 8LL * sms;
  row_gather_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<const uint32_t*>(idx),
      static_cast<uint4*>(out), rows, v, p);
  return (int)cudaGetLastError();
}
