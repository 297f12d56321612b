// Shared device helpers of the port's CUDA kernels.
//
// The hashes reproduce the JAX package's uint32 splitmix32 arithmetic
// (repro/kernels/common.py hash_u32_jnp / tie_noise_jnp) in native uint32_t,
// which wraps modulo 2^32 as the TPU version does.  Every float operation is
// written with an explicitly rounded intrinsic (and the files are built with
// -fmad=false) so no multiply and add fuse into an FMA: the kernels then
// round exactly where eager PyTorch's plain versions round.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// hash(a * 0x9E3779B1 ^ hash(b + seed)) scaled into [0, eps): `scale` is the
// float32 value of eps / 2^32.
__device__ __forceinline__ float tie_noise(uint32_t a, uint32_t b,
                                           uint32_t seed, float scale) {
  const uint32_t h = hash_u32((a * 0x9E3779B1u) ^ hash_u32(b + seed));
  return __fmul_rn(__uint2float_rn(h), scale);
}

// Argmax combine with ties going to the smaller id: (s, id) replaces
// (best, best_id) when it scores higher, or equal with a smaller id.
__device__ __forceinline__ void argmax_combine(float& best, int& best_id,
                                               float s, int id) {
  if (s > best || (s == best && id < best_id)) {
    best = s;
    best_id = id;
  }
}

}  // namespace repro_torch
