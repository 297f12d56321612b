// Row scoring of the two-step kernels (label_argmax.cu, delta_q.cu) on
// pre-gathered (R, width) tiles up to width 1024; the fused local_move
// kernels keep their own paths (local_move_plp.cuh, local_move_louvain.cuh).
//
// The bit contract is the fused kernels': a label's (candidate's) sum is
// the fold of its slots' weights from 0.0f, one __fadd_rn at a time, in
// ascending slot position — the additions of the block path's W*W scan
// and of its sort-and-run — so the two-step path and the fused kernels
// agree bit for bit on any weights, and equal the plain versions on
// integer weights.  Two paths, neither with a block barrier:
//
//  - width <= 16: a lane a row.  A thread holds its row's 16 labels and
//    weights (for delta_q also the volumes and sizes) in registers, loaded
//    by 16-byte loads straight from the tile, scans the 16 x 16 pairs and
//    takes the argmax in the thread, as the streamed kernels' W = 16 path
//    does (plp_score_lane, louvain_score_lane).
//
//  - 16 < width <= 1024 (instantiations W = 64, 256, 1024): a warp a row,
//    with a hash table of running sums in the warp's shared memory (label
//    -> the fold so far: the per-thread neighbourhood hash map of the
//    paper, which the TPU kernel turned into a W x W equality tensor),
//    O(W) work a row where sorting spends O(W log^2 W).  The row comes in
//    as 32-slot coalesced chunks (fold_row).  The table has 2W buckets (a
//    row holds at most W labels: the load stays at or below one half), a
//    label's probe starts at its Fibonacci hash, so strided labels do not
//    collide, and the buckets a row filled are emptied through a list (or
//    the slots' buckets), so a row costs nothing for the buckets it did
//    not use.
//
// The row key may be the sentinel on a row that still holds valid labels
// (the kernels take arbitrary tiles), so no row is settled from its key.
#pragma once
#include <climits>
#include <cmath>

#include "local_move_louvain.cuh"
#include "local_move_plp.cuh"

namespace repro_torch {

constexpr unsigned kFullWarp = 0xffffffffu;

// ------------------------------------------------------------ a lane a row

template <class V>
struct Vec4;
template <>
struct Vec4<int> {
  using T = int4;
};
template <>
struct Vec4<float> {
  using T = float4;
};

// Row r's slots of an (R, width) tile, width <= 16, into registers; slots
// from `width` on take `pad`.  `vec` (width == 16 and the tile 16-byte
// aligned): four 16-byte loads.
template <class V>
__device__ __forceinline__ void load_tile_row16(const V* __restrict__ t,
                                                long long r, int width,
                                                bool vec, V pad,
                                                V (&x)[16]) {
  if (vec) {
    const auto* p = reinterpret_cast<const typename Vec4<V>::T*>(t + r * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const auto a = __ldg(p + q);
      x[4 * q] = a.x, x[4 * q + 1] = a.y, x[4 * q + 2] = a.z,
      x[4 * q + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      x[k] = k < width ? __ldg(t + r * width + k) : pad;
  }
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// label_argmax of one row held by one lane: each slot's label scores its
// scan sum (the weights of the slots holding it, j ascending, from 0.0f)
// plus its tie noise; the argmax over the valid slots keeps the best,
// ties to the smaller label (a total order on non-NaN scores, so the
// order of the slots does not matter); the current label's score is that
// of a slot holding it — the block path's sum and noise, so its bits.
__device__ __forceinline__ void plp_tile_lane(const int (&lab)[16],
                                              const float (&wt)[16], int key,
                                              int cur, uint32_t seed,
                                              float scale, int sentinel,
                                              long long r,
                                              const PlpScores& out) {
  const uint32_t row_n = static_cast<uint32_t>(key);
  float best = -INFINITY, cur_score = 0.0f;
  int best_id = INT_MAX;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (lab[j] == lab[k]) s = __fadd_rn(s, wt[j]);
    const float eff = __fadd_rn(
        s, tie_noise(row_n, static_cast<uint32_t>(lab[k]), seed, scale));
    if (lab[k] != sentinel) {
      argmax_combine(best, best_id, eff, lab[k]);
      if (lab[k] == cur) cur_score = eff;
    }
  }
  out(r, best > -INFINITY ? best_id : -1, best, cur_score);
}

// delta_q of one row held by one lane: S_A is the fold of the valid slots
// holding A; each valid candidate other than A, unless the singleton rule
// blocks it, sums its S_k by the scan and scores louvain_gain from its own
// volume and size; the argmax keeps the best, ties to the smaller id.
__device__ __forceinline__ void louvain_tile_lane(
    const int (&cand)[16], const float (&wt)[16], const float (&vol)[16],
    const int (&size)[16], const LouvainRowTerms& a, float inv_vol,
    int singleton_rule, int sentinel, long long r, const LouvainGain& out) {
  float sa = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (cand[j] != sentinel && cand[j] == a.cur) sa = __fadd_rn(sa, wt[j]);
  float best = -INFINITY;
  int best_id = INT_MAX;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int ck = cand[k];
    if (ck == sentinel || ck == a.cur) continue;   // invalid or is_A
    if (singleton_blocked(a, ck, size[k], singleton_rule)) continue;
    float s_k = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (cand[j] == ck) s_k = __fadd_rn(s_k, wt[j]);
    argmax_combine(best, best_id,
                   louvain_gain(a, ck, s_k, sa, vol[k], size[k], inv_vol,
                                singleton_rule),
                   ck);
  }
  out(r, best > -INFINITY ? best_id : -1, best);
}

// ------------------------------------------------------------ a warp a row

// One warp's table of running sums: 2W buckets of (label, sum), an empty
// bucket holding (the sentinel, 0) — no valid label is the sentinel — and
// the list of the buckets the current row filled.
template <int W>
struct SumTable {
  static constexpr int kBuckets = 2 * W;
  static constexpr int kShift = 32 - log2_of(2 * W);
  int* key;
  float* sum;
  unsigned short* list;   // null: the caller clears through the slots
  unsigned char* claim;   // two arrays of 2W: a lane of the chunk per bucket
  float* wbuf;            // two arrays of 32: the chunk's weights by lane

  __device__ __forceinline__ static int home(int lab) {
    return static_cast<int>((static_cast<uint32_t>(lab) * 0x9E3779B1u) >>
                            kShift);
  }
  // The bucket that holds `lab`, read only (the row's folds are done).
  __device__ __forceinline__ int find(int lab, int sentinel) const {
    int b = home(lab);
    for (int k = key[b]; k != lab && k != sentinel; k = key[b])
      b = (b + 1) & (kBuckets - 1);
    return b;
  }
};

// The lanes of `valid` whose value of b (BITS bits) equals this lane's:
// one ballot a bit (the mask __match_any_sync gives).
template <int BITS>
__device__ __forceinline__ unsigned match_bits(int b, unsigned valid) {
  unsigned m = valid;
#pragma unroll
  for (int i = 0; i < BITS; ++i) {
    const unsigned v = __ballot_sync(kFullWarp, (b >> i) & 1);
    m &= ((b >> i) & 1) ? v : ~v;
  }
  return m;
}

// Walks the chunks c = 0, 1, ... of a row that lie below `width`, in
// order, G at a time: the next G chunks' loads (`load(c)`, one T a lane)
// are issued before the current G are used (`use(c0, x, nc)`: chunks c0
// .. c0 + nc - 1 of the row in x[0 .. nc - 1]).
template <int E, int G, class T, class Load, class Use>
__device__ __forceinline__ void chunk_groups(int width, const Load& load,
                                             const Use& use) {
  T cur[G], nxt[G];
#pragma unroll
  for (int e = 0; e < G; ++e) cur[e] = load(e);
  for (int c0 = 0; c0 < E && 32 * c0 < width; c0 += G) {
    const bool more = c0 + G < E && 32 * (c0 + G) < width;
    if (more) {
#pragma unroll
      for (int e = 0; e < G; ++e) nxt[e] = load(c0 + G + e);
    }
    const int left = (width - 32 * c0 + 31) / 32;
    use(c0, cur, left < G ? left : G);
    if (more) {
#pragma unroll
      for (int e = 0; e < G; ++e) cur[e] = nxt[e];
    }
  }
}

struct LabWeight {
  int lab;
  float w;
};

// Warps of a warp-a-row block at width W: the tables of a block stay
// within the 48 KB of static shared memory (22·W + 256 bytes a warp: 46 KB a
// block at W = 256, 44.5 KB at W = 1024).
template <int W>
struct WarpRows {
  static constexpr int kWarps = W >= 1024 ? 2 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int E = W / 32;
  // chunks loaded and probed together, at most k
  template <int k>
  static constexpr int group = E < k ? E : k;
};

// Pass 1 of a row, G chunks a group: every slot's weight folded into its
// label's sum, in slot order; the bucket of each slot (0xffff for
// padding) into `slot` if given.  Returns the number of buckets listed
// (t.list, if set; a bucket may be listed twice).  Per group, every valid
// lane first finds or inserts the labels of its G slots by linear probing
// (in any order), then the chunks are folded in order.  The lanes of a
// chunk that share a bucket share a label: if none do (each lane's claim
// on its bucket stands), each lane adds its weight to its bucket's sum;
// else the lowest lane of each label (its leader) adds the label's
// weights in lane order from the chunk's weights in shared memory — all
// of them, unrolled, when the chunk holds one label.  An empty bucket's
// sum is 0, so each sum is exactly the position-order fold from 0.0f.
template <int W, int G>
__device__ __forceinline__ int fold_row(const SumTable<W>& t,
                                        const int* __restrict__ lab_tile,
                                        const float* __restrict__ w_tile,
                                        long long off, int width, int sentinel,
                                        int lane, unsigned short* slot) {
  using WR = WarpRows<W>;
  const unsigned below = (1u << lane) - 1u;
  int n_list = 0, parity = 0;
  chunk_groups<WR::E, G, LabWeight>(
      width,
      [&](int c) {
        const int k = 32 * c + lane;
        return k < width ? LabWeight{__ldg(lab_tile + off + k),
                                     __ldg(w_tile + off + k)}
                         : LabWeight{sentinel, 0.0f};
      },
      [&](int c0, const LabWeight (&x)[G], int nc) {
        int b[G];
        unsigned valid[G];
        bool todo[G], fresh[G], wrote[G];
        bool left = false;
#pragma unroll
        for (int e = 0; e < G; ++e) {
          todo[e] = e < nc && x[e].lab != sentinel;
          valid[e] = __ballot_sync(kFullWarp, todo[e]);
          b[e] = todo[e] ? SumTable<W>::home(x[e].lab) : -1;
          fresh[e] = false;
          left |= todo[e];
        }
        // Probing in rounds, with plain stores: each unresolved slot reads
        // its bucket and, if it is empty, writes its label there; after a
        // __syncwarp the bucket holds one of the labels written (a key
        // changes only from the sentinel to a label within a row, so what
        // a slot reads then is final), and each slot decides on that: its
        // label resolves it (as new if it wrote), another sends it on.  The
        // slots of one label decide alike, so a label takes one bucket;
        // two of them may both count it as new.
        while (__any_sync(kFullWarp, left)) {
#pragma unroll
          for (int e = 0; e < G; ++e) {
            wrote[e] = false;
            if (!todo[e]) continue;
            volatile int* kb = t.key + b[e];
            if (*kb == sentinel) {
              *kb = x[e].lab;
              wrote[e] = true;
            }
          }
          __syncwarp();
          left = false;
#pragma unroll
          for (int e = 0; e < G; ++e) {
            if (!todo[e]) continue;
            if (*static_cast<volatile int*>(t.key + b[e]) == x[e].lab) {
              fresh[e] = wrote[e];
              todo[e] = false;
            } else {
              b[e] = (b[e] + 1) & (SumTable<W>::kBuckets - 1);
              left = true;
            }
          }
        }
#pragma unroll
        for (int e = 0; e < G; ++e) {
          if (t.list) {
            const unsigned filled = __ballot_sync(kFullWarp, fresh[e]);
            if (fresh[e])
              t.list[n_list + __popc(filled & below)] =
                  static_cast<unsigned short>(b[e]);
            n_list += __popc(filled);
          }
          if (slot && e < nc)
            slot[32 * (c0 + e) + lane] = static_cast<unsigned short>(b[e]);
        }
#pragma unroll
        for (int e = 0; e < G; ++e) {
          if (!valid[e]) continue;
          // The chunk's claims (a lane per bucket) and weights alternate
          // between two arrays, so one __syncwarp a chunk orders both them
          // and the previous chunk's sums.
          parity ^= 1;
          unsigned char* claim = t.claim + parity * 2 * W;
          float* wb = t.wbuf + parity * 32;
          if (b[e] >= 0) claim[b[e]] = static_cast<unsigned char>(lane);
          wb[lane] = x[e].w;
          __syncwarp();
          // all labels distinct (each claim stands): each lane adds its own
          if (__all_sync(kFullWarp, b[e] < 0 || claim[b[e]] == lane)) {
            if (b[e] >= 0) t.sum[b[e]] = __fadd_rn(t.sum[b[e]], x[e].w);
            continue;
          }
          // else the lowest lane of each label (its leader) adds the
          // label's weights in lane order; one label: all the chunk's
          const int first = __ffs(valid[e]) - 1;
          const int b0 = __shfl_sync(kFullWarp, b[e], first);
          const unsigned grp =
              __all_sync(kFullWarp, b[e] < 0 || b[e] == b0)
                  ? valid[e]
                  : match_bits<log2_of(2 * W)>(b[e], valid[e]);
          if (b[e] < 0 || __ffs(grp) - 1 != lane) continue;
          float s = t.sum[b[e]];
          if (grp == valid[e] && lane == first) {
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const float4 v = reinterpret_cast<const float4*>(wb)[q];
              if ((grp >> (4 * q)) & 1u) s = __fadd_rn(s, v.x);
              if ((grp >> (4 * q + 1)) & 1u) s = __fadd_rn(s, v.y);
              if ((grp >> (4 * q + 2)) & 1u) s = __fadd_rn(s, v.z);
              if ((grp >> (4 * q + 3)) & 1u) s = __fadd_rn(s, v.w);
            }
          } else {
            for (unsigned m = grp; m; m &= m - 1u)
              s = __fadd_rn(s, wb[__ffs(m) - 1]);
          }
          t.sum[b[e]] = s;
        }
      });
  __syncwarp();
  return n_list;
}

// Empties the buckets of a row's slots below `width` (`slot`: each slot's
// bucket, 0xffff for padding): key the sentinel, sum 0.
template <int W>
__device__ __forceinline__ void clear_slots(const SumTable<W>& t,
                                            const unsigned short* slot,
                                            int width, int sentinel,
                                            int lane) {
  __syncwarp();
  for (int k = lane; k < width; k += 32) {
    const int b = slot[k];
    if (b != 0xffff) {
      t.key[b] = sentinel;
      t.sum[b] = 0.0f;
    }
  }
  __syncwarp();
}

// Empties the n_list buckets of the list, once every lane has read them.
template <int W>
__device__ __forceinline__ void clear_list(const SumTable<W>& t, int n_list,
                                           int sentinel, int lane) {
  __syncwarp();
  for (int i = lane; i < n_list; i += 32) {
    const int b = t.list[i];
    t.key[b] = sentinel;
    t.sum[b] = 0.0f;
  }
  __syncwarp();
}

// Sets up a warp's table: every bucket empty.
template <int W>
__device__ __forceinline__ void init_table(const SumTable<W>& t,
                                           int sentinel, int lane) {
  for (int i = lane; i < 2 * W; i += 32) {
    t.key[i] = sentinel;
    t.sum[i] = 0.0f;
  }
  __syncwarp();
}

__device__ __forceinline__ void warp_argmax(float& best, int& best_id) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float b = __shfl_xor_sync(kFullWarp, best, s);
    const int id = __shfl_xor_sync(kFullWarp, best_id, s);
    argmax_combine(best, best_id, b, id);
  }
}

// The grid of a warp-a-row kernel: one row a warp, up to as many blocks as
// the card's SMs hold threads (2048 each); past that each warp walks rows
// wid, wid + warps of the grid, ..., so a table is set up once a warp.
__host__ inline int warp_blocks(int threads, int warps, long long n_rows,
                                unsigned& blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (n_rows + warps - 1) / warps;
  const long long room = static_cast<long long>(sms) * (2048 / threads);
  blocks = static_cast<unsigned>(need < room ? need : room);
  return 0;
}

}  // namespace repro_torch
