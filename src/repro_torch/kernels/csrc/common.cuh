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

// Threads of every local_move block, and how a block's threads split over
// rows of ELL width W: T threads per row, RPB rows per block (16 rows at
// W = 16, 4 at W = 64, one at W >= 256), so a narrow row never leaves most
// of a block idle.
constexpr int kLocalMoveThreads = 256;

template <int W>
struct RowGroup {
  static constexpr int T = W < kLocalMoveThreads ? W : kLocalMoveThreads;
  static constexpr int RPB = kLocalMoveThreads / T;
};

// A per-vertex table read from device memory through the read-only cache
// (the resident layout).
template <class V>
struct DeviceTable {
  const V* p;
  __device__ __forceinline__ V operator()(int v) const { return __ldg(p + v); }
};

// A block's window of a per-vertex table, staged in shared memory (the
// streamed layout): vertex v sits at v - lo.  The offset is clipped into
// the window as the plain version clips it, so an id that the window
// metadata failed to cover reads the same entry in both and never reads
// outside the window.
template <class V>
struct WindowTable {
  const V* s;
  long long lo;
  int len;
  __device__ __forceinline__ V operator()(int v) const {
    long long i = static_cast<long long>(v) - lo;
    i = i < 0 ? 0 : (i >= len ? len - 1 : i);
    return s[i];
  }
};

// Copies entries [lo, lo + len) of an n_tab-entry table into shared memory
// `s` with the whole block, consecutive threads on consecutive entries
// (coalesced); entries past the table's end take `fill`, the padding of
// the plain version's window_flat.  The caller synchronises after it.
template <class V>
__device__ __forceinline__ void stage_window(V* s, const V* __restrict__ tab,
                                             long long n_tab, long long lo,
                                             int len, V fill) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const long long v = lo + i;
    s[i] = v < n_tab ? tab[v] : fill;
  }
}

}  // namespace repro_torch
