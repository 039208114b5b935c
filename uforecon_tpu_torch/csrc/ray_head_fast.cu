// Fused along-ray SRDF head for Hopper (sm_90a), kernel_precision 'fast':
// the C 88 instances, the entry points and the pack size. The kernel, its
// design and what bounds it are in ray_head_fast.cuh; the other widths'
// instances in ray_head_fast_<C>.cu.
#include "ray_head_fast.cuh"

namespace ufo {
namespace rhf {

UFO_RHF_INSTANCES(88)

}  // namespace rhf
}  // namespace ufo

namespace {

// the widths of the instances (40 .. 112 in steps of 8)
bool fast_width(int c) { return c >= 40 && c <= 112 && c % 8 == 0; }

int launch_any(const float* y, const float* w, float* srdf, int rn, int sn, int c, bool neus,
               ufo::rhf::NeusOut nz, void* stream) {
  using namespace ufo::rhf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 40: return launch_c40(y, w, srdf, rn, sn, neus, nz, s);
    case 48: return launch_c48(y, w, srdf, rn, sn, neus, nz, s);
    case 56: return launch_c56(y, w, srdf, rn, sn, neus, nz, s);
    case 64: return launch_c64(y, w, srdf, rn, sn, neus, nz, s);
    case 72: return launch_c72(y, w, srdf, rn, sn, neus, nz, s);
    case 80: return launch_c80(y, w, srdf, rn, sn, neus, nz, s);
    case 88: return launch_c88(y, w, srdf, rn, sn, neus, nz, s);
    case 96: return launch_c96(y, w, srdf, rn, sn, neus, nz, s);
    case 104: return launch_c104(y, w, srdf, rn, sn, neus, nz, s);
    case 112: return launch_c112(y, w, srdf, rn, sn, neus, nz, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int C>
constexpr int pack_bytes() {
  return ufo::rhf::Layout<C>::BYTES;
}

}  // namespace

// Bytes of the fast kernel's weight pack (fast_image) at token width c
// (40 .. 112 in steps of 8), else -1: a width this kernel does not take.
extern "C" int ufo_ray_head_fast_pack_bytes(int c) {
  if (!fast_width(c)) return -1;
  constexpr int bytes[] = {pack_bytes<40>(), pack_bytes<48>(), pack_bytes<56>(),
                           pack_bytes<64>(), pack_bytes<72>(), pack_bytes<80>(),
                           pack_bytes<88>(), pack_bytes<96>(), pack_bytes<104>(),
                           pack_bytes<112>()};
  return bytes[(c - 40) / 8];
}

// Bytes of shared memory a block of the fast kernel takes at token width c,
// else -1 (the wide layout's from C 96 on).
extern "C" int ufo_ray_head_fast_smem_bytes(int c) {
  if (!fast_width(c)) return -1;
  using namespace ufo::rhf;
  constexpr int bytes[] = {Smem<40>::BYTES, Smem<48>::BYTES, Smem<56>::BYTES, Smem<64>::BYTES,
                           Smem<72>::BYTES, Smem<80>::BYTES, Smem<88>::BYTES, Smem<96>::BYTES,
                           Smem<104>::BYTES, Smem<112>::BYTES};
  return bytes[(c - 40) / 8];
}

// Returns a cudaError_t value (0 on success). c: 40 .. 112 in steps of 8;
// sn >= 1; w: the pack of ufo_ray_head_fast_pack_bytes(c) bytes, 16-byte
// aligned.
extern "C" int ufo_ray_head_fast(const float* y, const float* w, float* srdf, int rn, int sn,
                                 int c, void* stream) {
  return launch_any(y, w, srdf, rn, sn, c, false, ufo::rhf::NeusOut{}, stream);
}

// The same with the NeuS epilogue; the same return, c, sn and w rule.
extern "C" int ufo_ray_head_neus_fast(const float* y, const float* w, const float* z,
                                      const float* rad, const float* inv_s, float* srdf,
                                      float* weight, float* rgb, float* depth, float* opacity,
                                      int rn, int sn, int c, void* stream) {
  return launch_any(y, w, srdf, rn, sn, c, true,
                    ufo::rhf::NeusOut{z, rad, inv_s, weight, rgb, depth, opacity}, stream);
}

#ifdef UFO_RHF_PROBE
// the probe's per-phase cycles, phase-2 tiles and rays (ray_head_fast.cuh)
// of the instances at width c
extern "C" int ufo_ray_head_fast_probe(int c, unsigned long long* out) {
  using namespace ufo::rhf;
  switch (c) {
    case 40: return probe_c40(out);
    case 48: return probe_c48(out);
    case 56: return probe_c56(out);
    case 64: return probe_c64(out);
    case 72: return probe_c72(out);
    case 80: return probe_c80(out);
    case 88: return probe_c88(out);
    case 96: return probe_c96(out);
    case 104: return probe_c104(out);
    case 112: return probe_c112(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif
