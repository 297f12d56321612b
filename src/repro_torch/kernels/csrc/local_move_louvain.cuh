// Louvain row scoring shared by the fused kernels (local_move_louvain.cu
// resident, local_move_louvain_streamed.cu streamed) and the two-step
// scoring kernel (delta_q.cu).  They differ only in where a row's
// candidates and the row's own community terms come from (a row source
// below) and in what they write (an output sink below); the floats are
// added in the same order in all of them, so fused and two-step scoring
// agree bit for bit on any weights.
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
// The gain keeps exactly this association with every operation rounded
// separately (__fsub_rn/__fmul_rn, built with -fmad=false), as
// src/repro/kernels/delta_q/ref.py and eager PyTorch compute it.
//
// Candidates, weights, volumes and sizes of a row are staged once in shared
// memory (16 KB at W = 1024), so the W*W loop reads only shared memory.
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

// Row source of the two-step kernel: pre-gathered (R, width) candidate,
// weight, volume and size tiles, width <= W; staging entries past `width`
// are padding (the sentinel, 0), which no valid candidate equals.  The
// row's terms are its (R,) inputs.
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
    const float vol_a_minus = __fsub_rn(a.vol_cur, a.deg);
    for (int k = t; k < W; k += T) {
      const int ck = s_cand[sub][k];
      if (ck == sentinel || ck == cur) continue;  // invalid or is_A
      if (singleton_rule && a.size_cur == 1 && s_size[sub][k] == 1 && ck > cur)
        continue;                                  // gain = -inf
      float s_k = 0.0f;
      for (int j = 0; j < W; ++j)
        if (s_cand[sub][j] == ck) s_k = __fadd_rn(s_k, s_w[sub][j]);
      // ck != cur, so vol(B-) = vol_k - 0
      const float vol_b_minus = __fsub_rn(s_vol[sub][k], 0.0f);
      const float gain = __fsub_rn(
          __fsub_rn(s_k, sa),
          __fmul_rn(a.deg, __fmul_rn(__fsub_rn(vol_b_minus, vol_a_minus), inv_vol)));
      argmax_combine(best, best_id, gain, ck);
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
    const float vol_a_minus = __fsub_rn(a.vol_cur, a.deg);
    for (int p = t; p < P; p += T) {
      const int ck = s_cand[sub][p];
      if (ck == sentinel) break;
      if (ck == cur) continue;                   // is_A
      const int k = s_pos[sub][p];
      if (singleton_rule && a.size_cur == 1 && s_size[sub][k] == 1 && ck > cur)
        continue;                                  // gain = -inf
      // ck != cur, so vol(B-) = vol_k - 0
      const float vol_b_minus = __fsub_rn(s_vol[sub][k], 0.0f);
      const float gain = __fsub_rn(
          __fsub_rn(s_w[sub][p], sa),
          __fmul_rn(a.deg, __fmul_rn(__fsub_rn(vol_b_minus, vol_a_minus), inv_vol)));
      argmax_combine(best, best_id, gain, ck);
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

}  // namespace repro_torch
