// Louvain row scoring of the fused kernels (local_move_louvain.cu
// resident, local_move_louvain_streamed.cu streamed), and of the two-step
// scoring kernel (delta_q.cu) on tiles wider than 1024 only: up to 1024 it
// takes its own paths (tile_scoring.cuh), which add and round the same
// floats in the same order (louvain_gain, below).  They differ only in
// where a row's candidates and the row's own community terms come from (a
// row source below) and in what they write (an output sink below), so
// fused and two-step scoring agree bit for bit on any weights.
//
// Per row r (candidate community cand_k, weight w_k, candidate volume and
// size vol_k, size_k, k < W; the row's community A, degree deg, A's volume
// and size):
//   S_k = sum_j w_j [cand_j == cand_k],  S_A = sum_j w_j [valid_j and cand_j == A]
//   gain_k = (S_k - S_A) - deg * ((volB_k - volA) * inv_vol)
//     volB_k = vol_k - [cand_k == A] deg,  volA = vol(A) - deg
//   singleton rule: -inf when size(A) == size_k == 1 and cand_k > A
//   out = (argmax over valid k with cand_k != A, ties to the smaller id, or
//          -1; the best gain or -inf)
// The gain (louvain_gain, below) keeps exactly this association with every
// operation rounded separately (__fsub_rn/__fmul_rn, built with
// -fmad=false), as
// src/repro/kernels/delta_q/ref.py and eager PyTorch compute it.
//
// Candidates, weights, volumes and sizes of a row are staged once in shared
// memory (16 KB at W = 1024), so the W*W loop reads only shared memory.
// The streamed kernel's W = 16 path instead holds a row in one lane's
// registers (louvain_score_lane, at the end), with the same additions in
// the same order.
#pragma once
#include <climits>
#include <cmath>

#include "common.cuh"

namespace repro_torch {

// The row's own terms: its community A, degree, vol(A) and |A|.
struct LouvainRowTerms {
  int cur;
  float deg;
  float vol_cur;
  int size_cur;
};

// The singleton rule: a row alone in A may not move to a candidate ck > A
// that is itself alone.
__device__ __forceinline__ bool singleton_blocked(const LouvainRowTerms& a,
                                                  int ck, int size_k,
                                                  int singleton_rule) {
  return singleton_rule && a.size_cur == 1 && size_k == 1 && ck > a.cur;
}

// gain_k of a candidate ck != A (its weight sum s_k, volume vol_k and size
// size_k; S_A = sa), or -inf under the singleton rule.  Every scoring path
// calls it, so the rounding sequence is written here once.
__device__ __forceinline__ float louvain_gain(const LouvainRowTerms& a,
                                              int ck, float s_k, float sa,
                                              float vol_k, int size_k,
                                              float inv_vol,
                                              int singleton_rule) {
  if (singleton_blocked(a, ck, size_k, singleton_rule)) return -INFINITY;
  const float vol_a_minus = __fsub_rn(a.vol_cur, a.deg);
  const float vol_b_minus = __fsub_rn(vol_k, 0.0f);  // ck != A: vol_k - 0
  return __fsub_rn(
      __fsub_rn(s_k, sa),
      __fmul_rn(a.deg, __fmul_rn(__fsub_rn(vol_b_minus, vol_a_minus),
                                 inv_vol)));
}

// Row source of the fused kernels: candidates and their terms gathered from
// the per-VERTEX composed tables (com_v, volcom_v, sizecom_v, deg_v;
// ref.compose_louvain_tables), each a DeviceTable or a WindowTable
// (common.cuh), at the neighbour ids; sentinel ids take the sentinel and 0
// without reading a table.  The row's terms are the tables' entries of its
// vertex.
template <class Ints, class Floats>
struct LouvainGathered {
  const int* rows;
  const int* nbr;
  const float* w;
  Ints com_v;
  Floats volcom_v;
  Ints sizecom_v;
  Floats deg_v;
  int sentinel;
  __device__ __forceinline__ void stage(long long r, int k, int W, int& cand,
                                        float& wt, float& vol,
                                        int& size) const {
    const long long i = r * W + k;
    const int v = __ldg(nbr + i);
    const bool real = v < sentinel;
    cand = real ? com_v(v) : sentinel;
    vol = real ? volcom_v(v) : 0.0f;
    size = real ? sizecom_v(v) : 0;
    wt = __ldg(w + i);
  }
  __device__ __forceinline__ LouvainRowTerms row(long long r) const {
    const int v = __ldg(rows + r);
    if (v >= sentinel) return {sentinel, 0.0f, 0.0f, 0};
    return {com_v(v), deg_v(v), volcom_v(v), sizecom_v(v)};
  }
};

// Row source of the two-step kernel above width 1024: pre-gathered
// (R, width) candidate, weight, volume and size tiles, width <= W; staging
// entries past `width` are padding (the sentinel, 0), which no valid
// candidate equals.  The row's terms are its (R,) inputs.
struct LouvainTiles {
  const int* cand;
  const float* w;
  const float* vol_cand;
  const int* size_cand;
  const int* cur_com;
  const float* deg_v;
  const float* vol_cur;
  const int* size_cur;
  int width;
  int sentinel;
  __device__ __forceinline__ void stage(long long r, int k, int, int& c,
                                        float& wt, float& vol,
                                        int& size) const {
    const long long i = r * width + k;
    const bool in = k < width;
    c = in ? __ldg(cand + i) : sentinel;
    wt = in ? __ldg(w + i) : 0.0f;
    vol = in ? __ldg(vol_cand + i) : 0.0f;
    size = in ? __ldg(size_cand + i) : 0;
  }
  __device__ __forceinline__ LouvainRowTerms row(long long r) const {
    return {__ldg(cur_com + r), __ldg(deg_v + r), __ldg(vol_cur + r),
            __ldg(size_cur + r)};
  }
};

// Output sink of the fused kernels: (best community, propose = gain > 0).
struct LouvainProposal {
  int* out_best;
  unsigned char* out_prop;
  __device__ __forceinline__ void operator()(long long r, int cand,
                                             float gain) const {
    out_best[r] = cand;
    out_prop[r] = (cand >= 0 && gain > 0.0f) ? 1 : 0;
  }
};

// Output sink of the two-step kernel: (best community, best gain).
struct LouvainGain {
  int* out_cand;
  float* out_gain;
  __device__ __forceinline__ void operator()(long long r, int cand,
                                             float gain) const {
    out_cand[r] = cand;
    out_gain[r] = gain;
  }
};

// The W*W scan: thread 0 sums S_A in one pass over the row, then each
// thread scores candidates k = t, t + T, ... by summing the row's matching
// weights with j ascending.
template <int W, class Row, class Out>
__device__ __forceinline__ void louvain_score_rows_scan(
    const Row& src, float inv_vol, int singleton_rule, int sentinel,
    long long first, long long end, const Out& out) {
  constexpr int T = RowGroup<W>::T;
  constexpr int RPB = RowGroup<W>::RPB;
  __shared__ int s_cand[RPB][W];
  __shared__ float s_w[RPB][W];
  __shared__ float s_vol[RPB][W];
  __shared__ int s_size[RPB][W];
  __shared__ float s_best[RPB][T];
  __shared__ int s_id[RPB][T];
  __shared__ float s_sa[RPB];

  const int sub = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long r = first + sub;
  const bool live = r < end;

  if (live) {
    for (int k = t; k < W; k += T)
      src.stage(r, k, W, s_cand[sub][k], s_w[sub][k], s_vol[sub][k],
                s_size[sub][k]);
  }
  const LouvainRowTerms a =
      live ? src.row(r) : LouvainRowTerms{sentinel, 0.0f, 0.0f, 0};
  const int cur = a.cur;
  __syncthreads();
  if (live && t == 0) {
    float sa = 0.0f;
    for (int j = 0; j < W; ++j) {
      const int cj = s_cand[sub][j];
      if (cj != sentinel && cj == cur) sa = __fadd_rn(sa, s_w[sub][j]);
    }
    s_sa[sub] = sa;
  }
  __syncthreads();

  float best = -INFINITY;
  int best_id = INT_MAX;
  if (live) {
    const float sa = s_sa[sub];
    for (int k = t; k < W; k += T) {
      const int ck = s_cand[sub][k];
      if (ck == sentinel || ck == cur) continue;  // invalid or is_A
      if (singleton_blocked(a, ck, s_size[sub][k], singleton_rule))
        continue;                                 // -inf: skip the sum
      float s_k = 0.0f;
      for (int j = 0; j < W; ++j)
        if (s_cand[sub][j] == ck) s_k = __fadd_rn(s_k, s_w[sub][j]);
      argmax_combine(best, best_id,
                     louvain_gain(a, ck, s_k, sa, s_vol[sub][k],
                                  s_size[sub][k], inv_vol, singleton_rule),
                     ck);
    }
  }
  s_best[sub][t] = best;
  s_id[sub][t] = best_id;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) {
      float b = s_best[sub][t];
      int id = s_id[sub][t];
      argmax_combine(b, id, s_best[sub][t + s], s_id[sub][t + s]);
      s_best[sub][t] = b;
      s_id[sub][t] = id;
    }
    __syncthreads();
  }

  if (live && t == 0) {
    best = s_best[sub][0];
    out(r, best > -INFINITY ? s_id[sub][0] : -1, best);
  }
}

// Sort-and-run: the row's slots are sorted by (candidate, position); the
// thread that holds a run's first slot sums the run once and writes the
// sum over the run's weights (each slot's weight is then its candidate's
// S), and the current community's run gives S_A.  Every valid slot then
// scores its own gain from its own volume and size, as the scan does.
// Only the prefix of the row up to its last valid slot, rounded up to a
// power of two, is sorted.
template <int W, class Row, class Out>
__device__ __forceinline__ void louvain_score_rows_sorted(
    const Row& src, float inv_vol, int singleton_rule, int sentinel,
    long long first, long long end, const Out& out) {
  constexpr int T = RowGroup<W>::T;
  constexpr int RPB = RowGroup<W>::RPB;
  __shared__ int s_cand[RPB][W];
  __shared__ unsigned short s_pos[RPB][W];
  __shared__ float s_w[RPB][W];
  __shared__ float s_vol[RPB][W];
  __shared__ int s_size[RPB][W];
  __shared__ float s_best[RPB][T];
  __shared__ int s_id[RPB][T];
  __shared__ float s_sa[RPB];
  __shared__ int s_len[RPB];       // 1 + the row's last valid slot
  __shared__ int s_len_block;

  const int sub = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long r = first + sub;
  const bool live = r < end;
  if (t == 0) {
    s_len[sub] = 0;
    s_sa[sub] = 0.0f;
  }
  if (threadIdx.x == 0) s_len_block = 0;

  int last = -1;
  if (live) {
    for (int k = t; k < W; k += T) {
      src.stage(r, k, W, s_cand[sub][k], s_w[sub][k], s_vol[sub][k],
                s_size[sub][k]);
      s_pos[sub][k] = static_cast<unsigned short>(k);
      if (s_cand[sub][k] != sentinel) last = k;
    }
  }
  const LouvainRowTerms a =
      live ? src.row(r) : LouvainRowTerms{sentinel, 0.0f, 0.0f, 0};
  const int cur = a.cur;
  __syncthreads();
  if (last >= 0) {
    atomicMax(&s_len[sub], last + 1);
    atomicMax(&s_len_block, last + 1);
  }
  __syncthreads();
  const int P = pow2_ceil(s_len[sub]);
  sort_row<W, T>(s_cand[sub], s_pos[sub], s_w[sub], P,
                 pow2_ceil(s_len_block), t, sentinel);

  if (live) {
    for (int p = t; p < P; p += T) {
      const int ck = s_cand[sub][p];
      if (ck == sentinel) break;                 // sentinels sort last
      if (p > 0 && s_cand[sub][p - 1] == ck) continue;  // not a run's head
      const int end = run_end(s_cand[sub], p, P, ck);
      float s_k = 0.0f;
#pragma unroll 4
      for (int q = p; q < end; ++q) s_k = __fadd_rn(s_k, s_w[sub][q]);
      for (int q = p; q < end; ++q) s_w[sub][q] = s_k;
      if (ck == cur) s_sa[sub] = s_k;
    }
  }
  __syncthreads();

  float best = -INFINITY;
  int best_id = INT_MAX;
  if (live) {
    const float sa = s_sa[sub];
    for (int p = t; p < P; p += T) {
      const int ck = s_cand[sub][p];
      if (ck == sentinel) break;
      if (ck == cur) continue;                   // is_A
      const int k = s_pos[sub][p];
      argmax_combine(best, best_id,
                     louvain_gain(a, ck, s_w[sub][p], sa, s_vol[sub][k],
                                  s_size[sub][k], inv_vol, singleton_rule),
                     ck);
    }
  }
  s_best[sub][t] = best;
  s_id[sub][t] = best_id;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (t < s) {
      float b = s_best[sub][t];
      int id = s_id[sub][t];
      argmax_combine(b, id, s_best[sub][t + s], s_id[sub][t + s]);
      s_best[sub][t] = b;
      s_id[sub][t] = id;
    }
    __syncthreads();
  }

  if (live && t == 0) {
    best = s_best[sub][0];
    out(r, best > -INFINITY ? s_id[sub][0] : -1, best);
  }
}

// Scores rows first + (threadIdx.x / T) of the flat tiles, those below
// `end`; every thread of the block calls it (it synchronises the block).
// Narrow rows take the scan, wider ones the sort (kScanMaxWidth); both give
// the same bits.
template <int W, class Row, class Out>
__device__ __forceinline__ void louvain_score_rows(
    const Row& src, float inv_vol, int singleton_rule, int sentinel,
    long long first, long long end, const Out& out) {
  if constexpr (W <= kScanMaxWidth)
    louvain_score_rows_scan<W>(src, inv_vol, singleton_rule, sentinel, first,
                               end, out);
  else
    louvain_score_rows_sorted<W>(src, inv_vol, singleton_rule, sentinel,
                                 first, end, out);
}

// ------------------------------------------------------------ one warp a row
//
// The resident kernel's path at the widths local_move_louvain.cu picks
// (W = 32·E, E <= 8): one warp scores one row at a time, with no block
// barrier, so no row waits on another row's staging or sort.
//
// Tile contract (graph/ell.py: build_ell and traced_ell_tile both
// guarantee it): a row whose id is the sentinel holds only sentinel slots
// of weight 0, so the plain version gives it (-1, no move).  This path
// writes that from the row id alone and never reads such a row's slots.
//
// A warp takes G consecutive rows: one coalesced read of their row ids and
// the dead rows written at once; then the slot ids of all its live rows,
// loaded together, and the live rows with no real slot (a late coarse
// level's rows mostly hold their masked loop alone) written at once; then
// the other live rows one after another.  Per such row:
//  - the W ids again in E coalesced 32-slot loads (mostly cache hits); a
//    slot's weight and its three table entries are read only where its id
//    is real (a padding slot's weight takes no part in any sum).  Every id
//    of a live row is read: stopping at its second sentinel (the builders'
//    layout, graph/ell.py) took a late coarse tile from 0.138 to 0.109 ms
//    on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), but would
//    give wrong moves on a tile whose padding lies anywhere in a row,
//    which the kernels take;
//  - the keys (candidate, slot) sorted in registers (common.cuh
//    warp_sort_keys) up to the row's last valid slot;
//  - run heads by ballot; each run is summed by the lane that holds its
//    head, one __fadd_rn at a time in position order from 0.0f — the very
//    additions of louvain_score_rows_sorted and of the scan — and S_A is
//    the current community's run;
//  - every valid slot's gain from its own volume and size by
//    louvain_gain, as in the block path, and the argmax by shuffles (ties
//    to the smaller id).
// Shared memory holds only the warp's own row (weights by slot and by
// sorted index, volumes, sizes: 16·W bytes a warp); __syncwarp orders it.

// The sorted index where the run that starts at head h ends: the next
// head, or n_valid.
template <int E>
__device__ __forceinline__ int next_head(const unsigned (&head)[E], int h,
                                         int n_valid) {
  const int eh = h >> 5;
  const unsigned above = (h & 31) == 31 ? 0u : ~0u << ((h & 31) + 1);
#pragma unroll
  for (int f = 0; f < E; ++f) {
    if (f < eh) continue;
    const unsigned m = f == eh ? head[f] & above : head[f];
    if (m) return 32 * f + __ffs(m) - 1;
  }
  return n_valid;
}

// The head of the run that holds sorted index i (< n_valid).
template <int E>
__device__ __forceinline__ int head_of(const unsigned (&head)[E], int i) {
  const int ei = i >> 5;
  const unsigned upto = 0xffffffffu >> (31 - (i & 31));
  int h = 0;
#pragma unroll
  for (int f = 0; f < E; ++f) {
    if (f > ei) continue;
    const unsigned m = f == ei ? head[f] & upto : head[f];
    if (m) h = 32 * f + 31 - __clz(m);
  }
  return h;
}

// Scores rows [first, first + G) below `end`, one warp; every lane of the
// warp calls it.  K is the sort key type (32-bit while the sentinel is
// below 2^(32 - log2 W), common.cuh narrow_keys).
template <class K, int W, int G, class Ints, class Floats>
__device__ __forceinline__ void louvain_rows_by_warp(
    const LouvainGathered<Ints, Floats>& src, float inv_vol,
    int singleton_rule, long long first, long long end,
    const LouvainProposal& out) {
  static_assert(W % 32 == 0 && W <= 256, "W = 32·E, E <= 8");
  static_assert(G >= 1 && G <= 32, "a warp takes 1..32 rows");
  using Key = SlotKey<K, W>;
  constexpr int E = W / 32;
  constexpr int kWarps = kLocalMoveThreads / 32;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ float s_w[kWarps][W];     // weight by slot
  __shared__ float s_ws[kWarps][W];    // by sorted index; a head: its run's S
  __shared__ float s_vol[kWarps][W];
  __shared__ int s_size[kWarps][W];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  float* w_slot = s_w[wid];
  float* w_sorted = s_ws[wid];
  float* vol_slot = s_vol[wid];
  int* size_slot = s_size[wid];
  const int sentinel = src.sentinel;

  const long long r_mine = first + lane;
  const bool mine = lane < G && r_mine < end;
  const int v_mine = mine ? __ldg(src.rows + r_mine) : sentinel;
  if (mine && v_mine >= sentinel) out(r_mine, -1, -INFINITY);  // dead row
  const unsigned live = __ballot_sync(kAll, mine && v_mine < sentinel);
  // The live rows' ids, all loaded at once: a row with no real id has no
  // candidate and is settled here; the others are scored one at a time.
  unsigned busy = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    bool real = false;
#pragma unroll
    for (int e = 0; e < E; ++e)
      real |= ((live >> g) & 1u) &&
              __ldg(src.nbr + (first + g) * W + 32 * e + lane) < sentinel;
    busy |= __ballot_sync(kAll, real) ? 1u << g : 0u;
  }
  if (lane < G && ((live & ~busy) >> lane) & 1u) out(r_mine, -1, -INFINITY);
  while (busy) {
    const int j = __ffs(busy) - 1;
    busy &= busy - 1;
    const long long r = first + j;
    const int v = __shfl_sync(kAll, v_mine, j);
    const long long off = r * W;
    int id[E];
#pragma unroll
    for (int e = 0; e < E; ++e) id[e] = __ldg(src.nbr + off + 32 * e + lane);
    const LouvainRowTerms a{src.com_v(v), src.deg_v(v), src.volcom_v(v),
                            src.sizecom_v(v)};
    K key[E];
    int n_valid = 0, last = -1;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int k = 32 * e + lane;
      const bool real = id[e] < sentinel;
      const int cand = real ? src.com_v(id[e]) : sentinel;
      w_slot[k] = real ? __ldg(src.w + off + k) : 0.0f;
      vol_slot[k] = real ? src.volcom_v(id[e]) : 0.0f;
      size_slot[k] = real ? src.sizecom_v(id[e]) : 0;
      key[e] = Key::make(cand, k);
      const unsigned valid = __ballot_sync(kAll, cand != sentinel);
      n_valid += __popc(valid);
      if (valid) last = 32 * e + 31 - __clz(valid);
    }
    if (n_valid == 0) {                      // no candidate: (-1, no move)
      if (lane == 0) out(r, -1, -INFINITY);
      __syncwarp();
      continue;
    }
    __syncwarp();                            // the slot arrays are written
    warp_sort_keys<K, W>(key, pow2_ceil(last + 1), lane);

    // sorted index i = 32·e + lane: valid keys lie in [0, n_valid)
    int lab[E];
    unsigned head[E];
    int carry = 0;                           // the label at index 32·e - 1
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = 32 * e + lane;
      lab[e] = Key::label(key[e]);
      if (i < n_valid) w_sorted[i] = w_slot[Key::pos(key[e])];
      int prev = __shfl_up_sync(kAll, lab[e], 1);
      if (lane == 0) prev = carry;
      carry = __shfl_sync(kAll, lab[e], 31);
      head[e] = __ballot_sync(kAll, i < n_valid && (i == 0 || lab[e] != prev));
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if ((head[e] >> lane) & 1u) {          // this lane holds a run's head
        const int h = 32 * e + lane;
        const int stop = next_head(head, h, n_valid);
        float s = 0.0f;
        for (int q = h; q < stop; ++q) s = __fadd_rn(s, w_sorted[q]);
        w_sorted[h] = s;                     // no other run reads index h
      }
    }
    __syncwarp();
    float sa = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const unsigned m =
          __ballot_sync(kAll, ((head[e] >> lane) & 1u) && lab[e] == a.cur);
      if (m) sa = w_sorted[32 * e + __ffs(m) - 1];
    }

    float best = -INFINITY;
    int best_id = INT_MAX;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = 32 * e + lane;
      const int ck = lab[e];
      if (i >= n_valid || ck == a.cur) continue;     // invalid or is_A
      const int k = Key::pos(key[e]);
      argmax_combine(best, best_id,
                     louvain_gain(a, ck, w_sorted[head_of(head, i)], sa,
                                  vol_slot[k], size_slot[k], inv_vol,
                                  singleton_rule),
                     ck);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float b = __shfl_xor_sync(kAll, best, s);
      const int id_b = __shfl_xor_sync(kAll, best_id, s);
      argmax_combine(best, best_id, b, id_b);
    }
    if (lane == 0) out(r, best > -INFINITY ? best_id : -1, best);
    __syncwarp();                            // the next row reuses the arrays
  }
}

// ------------------------------------------------------------ a lane a row
//
// The Louvain move of one W = 16 row held by one lane (common.cuh
// lane_rows), on the block's windows of the four composed tables: its slot
// ids and weights in registers, v the row's (real) id.  S_A is the block
// path's thread-0 pass (the weights of the valid slots holding A, j
// ascending); each valid candidate other than A, unless the singleton rule
// blocks it, sums its S_k by the scan and scores louvain_gain from its own
// volume and size; the argmax keeps the best, ties to the smaller id.
template <class Ints, class Floats>
__device__ __forceinline__ void louvain_score_lane(
    const Ints& com_v, const Floats& volcom_v, const Ints& sizecom_v,
    const Floats& deg_v, float inv_vol, int singleton_rule, int sentinel,
    long long r, int v, const int (&id)[16], const float (&wt)[16],
    const LouvainProposal& out) {
  int cand[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) cand[k] = id[k] < sentinel ? com_v(id[k]) : sentinel;
  const LouvainRowTerms a{com_v(v), deg_v(v), volcom_v(v), sizecom_v(v)};
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
    const int size_k = sizecom_v(id[k]);
    if (singleton_blocked(a, ck, size_k, singleton_rule)) continue;
    float s_k = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (cand[j] == ck) s_k = __fadd_rn(s_k, wt[j]);
    argmax_combine(best, best_id,
                   louvain_gain(a, ck, s_k, sa, volcom_v(id[k]), size_k,
                                inv_vol, singleton_rule),
                   ck);
  }
  out(r, best > -INFINITY ? best_id : -1, best);
}

}  // namespace repro_torch
