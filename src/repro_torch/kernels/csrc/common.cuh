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
// outside the window.  The W = 16 path takes I = int: ids and window bases
// lie in [0, sentinel], so v - lo fits 32 bits (its kernels ran 2-4 %
// faster so; tools/ab_kernels.py local_move_streamed, H100).
template <class V, class I = long long>
struct WindowTable {
  const V* s;
  I lo;
  int len;
  __device__ __forceinline__ V operator()(int v) const {
    I i = static_cast<I>(v) - lo;
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

// ------------------------------------------------------------ a lane a row
//
// The streamed kernels' path at W = 16 (local_move_plp_streamed.cu,
// local_move_louvain_streamed.cu): each thread scores whole rows, a row's
// 16 slot ids and weights in its registers, so a row's scan, argmax and
// current-label sum cost no shuffle, no ballot and no barrier, and one
// warp instruction serves 32 rows; the block synchronises once, after
// staging its windows.  At W = 16 the work a row is small enough that
// what a row costs in issued instructions decides the time: half a warp a
// row (lane k slot k, shuffles for the scan and the argmax) issued about
// 270 warp instructions for every two rows and took 0.0485 / 0.0517 ms
// (PLP / Louvain) on the com-dblp stand-in's bucket where a lane a row
// takes 0.0277 for either (NVIDIA H100 80GB HBM3, 700 W;
// tools/ab_kernels.py local_move_streamed).

// Copies a window like stage_window, but with 16-byte cp.async copies
// (LDGSTS) for the 4-entry chunks that lie inside the table, so the
// block's threads go on issuing loads while it lands; entries of a chunk
// across or past the table's end take `fill` by plain stores.  `s` and
// `tab + lo` are 16-byte aligned where the chunks are copied (lo is a
// multiple of the slot, itself of TABLE_LANE = 128 entries; the caller
// checks the table's base), and len is a multiple of 4.  The caller waits
// with cp_async_wait_all() and then synchronises the block.
template <class V>
__device__ __forceinline__ void stage_window_async(V* s,
                                                   const V* __restrict__ tab,
                                                   long long n_tab,
                                                   long long lo, int len,
                                                   V fill) {
  static_assert(sizeof(V) == 4, "4-byte table entries");
  for (int c = threadIdx.x; 4 * c < len; c += blockDim.x) {
    const long long v = lo + 4 * c;
    if (v + 4 <= n_tab) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(s + 4 * c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(tab + v));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * c + e] = v + e < n_tab ? tab[v + e] : fill;
    }
  }
}

// Waits for the calling thread's cp.async copies (none is fine).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The window copy of the W = 16 path: by cp.async where `tab` is 16-byte
// aligned, else as stage_window.  The asynchronous copy lets a thread issue
// its first row's loads while the window lands: with plain loads and
// stores the same kernels took 14 % (PLP, a 2 KB window) and 30 %
// (Louvain, 8 KB) longer (tools/ab_kernels.py local_move_streamed, H100).
template <class V>
__device__ __forceinline__ void stage_window_w16(V* s, const V* __restrict__ tab,
                                                 long long n_tab, long long lo,
                                                 int len, V fill) {
  if ((reinterpret_cast<unsigned long long>(tab) & 15) == 0)
    stage_window_async(s, tab, n_tab, lo, len, fill);
  else
    stage_window(s, tab, n_tab, lo, len, fill);
}

// Row r's 16 slot ids and weights into registers: four 16-byte loads
// each where the tiles are 16-byte aligned (`vec`), else 16 loads each.
__device__ __forceinline__ void load_row16(const int* __restrict__ nbr,
                                           const float* __restrict__ w,
                                           long long r, bool vec,
                                           int (&id)[16], float (&wt)[16]) {
  if (vec) {
    const int4* n4 = reinterpret_cast<const int4*>(nbr + r * 16);
    const float4* w4 = reinterpret_cast<const float4*>(w + r * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 a = __ldg(n4 + q);
      const float4 b = __ldg(w4 + q);
      id[4 * q] = a.x, id[4 * q + 1] = a.y, id[4 * q + 2] = a.z,
      id[4 * q + 3] = a.w;
      wt[4 * q] = b.x, wt[4 * q + 1] = b.y, wt[4 * q + 2] = b.z,
      wt[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      id[k] = __ldg(nbr + r * 16 + k);
      wt[k] = __ldg(w + r * 16 + k);
    }
  }
}

// The row loop of the W = 16 path, for a block over rows [start, end) of
// (R, 16) tiles: thread t takes rows start + t, start + t + blockDim.x,
// ...  A row whose id is the sentinel is written (-1, none) from its id
// alone by `none(r)`: under the tile contract (graph/ell.py
// tile_contract) it holds only sentinel slots of weight 0.  Each live row
// goes to `score(r, v, id, wt)`: its index, id, slot ids and weights.
// `stage()` issues the copy of the block's windows (stage_window_w16)
// after the first row id's load and before that row's slot loads, which
// are made only for a real id; the block's one __syncthreads follows them.
//
// With kPrefetch a thread loads its next row (id, slot ids and weights,
// whatever the id) before it scores the current one.  PLP takes it: on an
// H100 (tools/ab_kernels.py local_move_streamed) its kernel ran 0.0277
// ms where the loop without it ran 0.0317, even at one row a thread,
// where nothing is prefetched — without it the compiler keeps the scan's
// compares in general registers (P2R, LOP3; 1 808 instructions against
// 1 536) — and 0.0313 against 0.0340 at two rows a thread.  Louvain does
// not: its registers rise from 70 to 96, and it loses 13-15 %.
template <bool kPrefetch, class Stage, class None, class Score>
__device__ __forceinline__ void lane_rows(const int* __restrict__ rows,
                                          const int* __restrict__ nbr,
                                          const float* __restrict__ w,
                                          int sentinel, long long start,
                                          long long end, const Stage& stage,
                                          const None& none,
                                          const Score& score) {
  const bool vec = ((reinterpret_cast<unsigned long long>(nbr) |
                     reinterpret_cast<unsigned long long>(w)) & 15) == 0;
  long long r = start + threadIdx.x;
  int v = r < end ? __ldg(rows + r) : sentinel;
  stage();
  int id[16];
  float wt[16];
  if (v < sentinel) load_row16(nbr, w, r, vec, id, wt);
  cp_async_wait_all();
  __syncthreads();
  for (; r < end; r += blockDim.x) {
    if constexpr (kPrefetch) {
      const long long rn = r + blockDim.x;
      int vn = sentinel, idn[16];
      float wtn[16];
      if (rn < end) {
        vn = __ldg(rows + rn);
        load_row16(nbr, w, rn, vec, idn, wtn);
      }
      if (v < sentinel) score(r, v, id, wt);
      else none(r);
      v = vn;
#pragma unroll
      for (int k = 0; k < 16; ++k) id[k] = idn[k], wt[k] = wtn[k];
    } else {
      if (r != start + threadIdx.x) {
        v = __ldg(rows + r);
        if (v < sentinel) load_row16(nbr, w, r, vec, id, wt);
      }
      if (v < sentinel) score(r, v, id, wt);
      else none(r);
    }
  }
}

}  // namespace repro_torch
