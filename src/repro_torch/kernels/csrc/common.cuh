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

// ---------------------------------------------------------------- sort-and-run
//
// The scoring headers (local_move_plp.cuh, local_move_louvain.cuh) score a
// staged row by sorting its W slots by (label, position) and summing each
// label's run once, in ascending position order, from 0.0f with __fadd_rn:
// the very additions, in the very order, that a scan over the row makes
// for that label, so a run's sum is bit-identical to the scan's on any
// weights.  Sorting takes (W/2)·log2 W·(log2 W + 1)/2 compare-exchanges
// where the scan takes W·W compare-adds.

// Widths up to this keep the W*W scan; both give the same bits.  Timed on
// an H100 (700 W; tools/ab_kernels.py local_move and chip_smoke.py): at
// W = 16 the scan takes 0.17 ms where the sort takes 0.26 (810 488 rows);
// at W = 64 the scan is 7-45 % faster on dense rows that hold few labels,
// but the sort is faster on sparse ones, which it sorts only up to their
// last valid slot, and those dominate: a coarse level's traced W = 64
// tile of the as-skitter stand-in (2^21 rows, 82 launches a run) takes
// 1.25 ms sorted and 1.64 ms scanned.  At W >= 256 the sort is 1.2-8x
// faster.
constexpr int kScanMaxWidth = 16;

// A slot's sort key: its label above log2 W position bits, unique per
// slot and ordered by (label, position) — the caller's labels lie in
// [0, sentinel], so the sentinel sorts after every valid label.  32-bit
// keys hold it while sentinel < 2^(32 - log2 W) (every graph of up to 4 M
// vertices at W = 1024), 64-bit keys past that.
__host__ __device__ constexpr int log2_of(int x) {
  return x <= 1 ? 0 : 1 + log2_of(x / 2);
}

template <class K, int W>
struct SlotKey {
  static constexpr int kBits = log2_of(W);
  __device__ __forceinline__ static K make(int lab, int pos) {
    return (static_cast<K>(lab) << kBits) | static_cast<K>(pos);
  }
  __device__ __forceinline__ static int label(K key) {
    return static_cast<int>(key >> kBits);
  }
  __device__ __forceinline__ static int pos(K key) {
    return static_cast<int>(key & (W - 1));
  }
};

template <int W>
__host__ __device__ __forceinline__ bool narrow_keys(int sentinel) {
  return sentinel < (1LL << (32 - log2_of(W)));
}

// The smallest power of two >= x (0 for x = 0).
__device__ __forceinline__ int pow2_ceil(int x) {
  return x <= 1 ? x : 1 << (32 - __clz(x - 1));
}

// One compare-exchange of a bitonic network on element i (key `mine`,
// partner's key `other`, partner index i ^ j) in the merge of size k:
// the lower index of an ascending pair keeps the smaller key.
template <class K>
__device__ __forceinline__ K bitonic_keep(K mine, K other, int i, int j,
                                          int k) {
  const bool low = (i & j) == 0;
  const bool ascending = (i & k) == 0;
  return (low == ascending) ? (mine < other ? mine : other)
                            : (mine < other ? other : mine);
}

// The bitonic network of sort_row on keys of type K.
template <class K, int W, int T>
__device__ __forceinline__ void sort_row_keys(int* lab, unsigned short* pos,
                                              float* w, int P, int p_block,
                                              int t) {
  using Key = SlotKey<K, W>;
  constexpr int E = W / T;
  K key[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    key[e] = Key::make(lab[t * E + e], pos[t * E + e]);
#pragma unroll
  for (int lk = 1; lk <= log2_of(W); ++lk) {
    const int k = 1 << lk;
    if (k > p_block) continue;               // block-uniform
    const bool run = k <= P;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j < E) {                           // within a thread
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & j) == 0 && run) {
            const int i = t * E + e;
            const K a = key[e], b = key[e | j];
            key[e] = bitonic_keep(a, b, i, j, k);
            key[e | j] = bitonic_keep(b, a, i | j, j, k);
          }
        }
      } else if (j < 32 * E) {               // within a warp
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const K other = __shfl_xor_sync(0xffffffffu, key[e], j / E);
          if (run) key[e] = bitonic_keep(key[e], other, t * E + e, j, k);
        }
      } else {                               // between warps
        if (run) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            lab[t * E + e] = Key::label(key[e]);
            pos[t * E + e] = static_cast<unsigned short>(Key::pos(key[e]));
          }
        }
        __syncthreads();
        if (run) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int i = t * E + e;
            const K other = Key::make(lab[i ^ j], pos[i ^ j]);
            key[e] = bitonic_keep(key[e], other, i, j, k);
          }
        }
        __syncthreads();
      }
    }
  }
  float w_sorted[E];
  if (P > 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) w_sorted[e] = w[Key::pos(key[e])];
  }
  __syncthreads();                           // every weight read first
  if (P > 1) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      lab[t * E + e] = Key::label(key[e]);
      pos[t * E + e] = static_cast<unsigned short>(Key::pos(key[e]));
      w[t * E + e] = w_sorted[e];
    }
  }
  __syncthreads();
}

// Sorts one row's staged slots by (label, position) — a bitonic network
// over the row's T threads, each holding E = W / T consecutive slots'
// keys in registers: exchanges within a thread stay in registers, within
// a warp go through shuffles, and only those between warps go through the
// row's staging arrays `lab`/`pos` in shared memory, with two block-wide
// barriers each (6 exchanges of the 55 at W = 1024).  On return `lab`,
// `pos` and the weights `w` hold the slots in sorted order (`pos` the
// slot each came from), so a run's weights lie side by side.  Only the
// network up to P (a power of two,
// or 0) runs on a row whose slots from P on are all the sentinel: they
// already sit in order after every valid slot.  Every thread of the block
// calls it; the passes run up to the block's largest P, `p_block`, and the
// caller synchronises the block between the staging and this call.
template <int W, int T>
__device__ __forceinline__ void sort_row(int* lab, unsigned short* pos,
                                         float* w, int P, int p_block, int t,
                                         int sentinel) {
  if (narrow_keys<W>(sentinel))
    sort_row_keys<uint32_t, W, T>(lab, pos, w, P, p_block, t);
  else
    sort_row_keys<unsigned long long, W, T>(lab, pos, w, P, p_block, t);
}

// Sorts one row's W = 32·E keys held by one warp, entirely in registers:
// element i = 32·e + lane is `key[e]` of that lane, so the exchanges at
// distance j < 32 are shuffles and those at j >= 32 stay within a lane;
// no shared memory and no barrier.  Only the network up to P (a power of
// two, or 0; warp-uniform) runs, as in sort_row_keys: elements from P on
// are the row's trailing sentinels, already after every valid key, and
// the merges leave [0, P) ascending.
template <class K, int W>
__device__ __forceinline__ void warp_sort_keys(K (&key)[W / 32], int P,
                                               int lane) {
  constexpr int E = W / 32;
#pragma unroll
  for (int lk = 1; lk <= log2_of(W); ++lk) {
    const int k = 1 << lk;
    if (k > P) break;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
      if (j >= 32) {                         // within a lane
        const int je = j / 32;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & je) == 0 && 32 * e < P) {
            const int i = 32 * e + lane;
            const K a = key[e], b = key[e | je];
            key[e] = bitonic_keep(a, b, i, j, k);
            key[e | je] = bitonic_keep(b, a, i | j, j, k);
          }
        }
      } else {                               // across lanes
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (32 * e < P) {
            const K other = __shfl_xor_sync(0xffffffffu, key[e], j);
            key[e] = bitonic_keep(key[e], other, 32 * e + lane, j, k);
          }
        }
      }
    }
  }
}

// The end of the run of label `lk` that starts at sorted slot p (< P):
// the first slot after it holding another label, found by galloping
// (p + 1, p + 2, p + 4, ...) and then bisecting, so a run of L slots
// costs O(log L) dependent loads, and one of length 1 a single load.
__device__ __forceinline__ int run_end(const int* lab, int p, int P, int lk) {
  int lo = p, step = 1;                      // lab[lo] == lk
  while (lo + step < P && lab[lo + step] == lk) {
    lo += step;
    step <<= 1;
  }
  int hi = min(lo + step, P);                // lab[hi] != lk, or hi == P
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (lab[mid] == lk) lo = mid; else hi = mid;
  }
  return hi;
}

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
