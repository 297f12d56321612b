// PLP row scoring of the fused kernels (local_move_plp.cu resident,
// local_move_plp_streamed.cu streamed), and of the two-step scoring kernel
// (label_argmax.cu) on tiles wider than 1024 only: up to 1024 it takes its
// own paths (tile_scoring.cuh), which add the same floats in the same
// order.  They differ only in where a row's labels come from (a row source
// below) and in what they write (an output sink below), so fused and
// two-step scoring agree bit for bit on any weights.
//
// Per row r (noise key row_r, labels lab_k, weights w_k, k < W):
//   score  = sum_j w_j [lab_j == lab_k] + tie_noise(row_r, lab_k)
//   best   = argmax over valid k (lab_k != sentinel), ties to the smaller label
//   cur    = sum_j w_j [lab_j == cur_r] + noise, or 0 if cur_r is absent
//   out    = (best label or -1, best score or -inf, cur)
//
// A row's labels and weights are staged once in shared memory (8 KB at
// W = 1024), so the W*W loop reads only shared memory.  Each thread scores
// candidates k = t, t + T, ... with j ascending; a shared-memory tree takes
// the row's argmax.  The streamed kernel's W = 16 path instead holds a row
// in one lane's registers (plp_score_lane, at the end), with the same
// additions in the same order.
#pragma once
#include <climits>
#include <cmath>

#include "common.cuh"

namespace repro_torch {

// Row source of the fused kernels: row r's labels are gathered from the
// label table (a DeviceTable or a WindowTable, common.cuh) at its neighbour
// ids; sentinel ids keep the sentinel and never read the table.  The noise
// key is the row's vertex id (the sentinel for a padding row), the current
// label the table's entry of that vertex, read at the key so the row id is
// loaded once.
template <class Labels>
struct PlpGathered {
  const int* rows;
  const int* nbr;
  const float* w;
  Labels labels;
  int sentinel;
  __device__ __forceinline__ void stage(long long r, int k, int W, int& lab,
                                        float& wt) const {
    const long long i = r * W + k;
    const int v = __ldg(nbr + i);
    lab = v < sentinel ? labels(v) : sentinel;
    wt = __ldg(w + i);
  }
  __device__ __forceinline__ int key(long long r) const {
    const int row = __ldg(rows + r);
    return row < sentinel ? row : sentinel;
  }
  __device__ __forceinline__ int cur(long long, int key) const {
    return key < sentinel ? labels(key) : sentinel;
  }
};

// Row source of the two-step kernel above width 1024: pre-gathered
// (R, width) label and weight tiles, width <= W; staging entries past `width` are padding (the
// sentinel label, weight 0), which no valid label equals, so they add
// nothing.  The noise key and the current label are the row's inputs.
struct PlpTiles {
  const int* nbr_lab;
  const float* nbr_w;
  const int* cur_lab;
  const int* rows;
  int width;
  int sentinel;
  __device__ __forceinline__ void stage(long long r, int k, int, int& lab,
                                        float& wt) const {
    const long long i = r * width + k;
    lab = k < width ? __ldg(nbr_lab + i) : sentinel;
    wt = k < width ? __ldg(nbr_w + i) : 0.0f;
  }
  __device__ __forceinline__ int key(long long r) const {
    return __ldg(rows + r);
  }
  __device__ __forceinline__ int cur(long long r, int) const {
    return __ldg(cur_lab + r);
  }
};

// Output sink of the fused kernels: (best label, propose = best > cur).
struct PlpProposal {
  int* out_best;
  unsigned char* out_prop;
  __device__ __forceinline__ void operator()(long long r, int lab, float best,
                                             float cur) const {
    out_best[r] = lab;
    out_prop[r] = (lab >= 0 && best > cur) ? 1 : 0;
  }
};

// Output sink of the two-step kernel: (best label, best score, cur score).
struct PlpScores {
  int* out_lab;
  float* out_best;
  float* out_cur;
  __device__ __forceinline__ void operator()(long long r, int lab, float best,
                                             float cur) const {
    out_lab[r] = lab;
    out_best[r] = best;
    out_cur[r] = cur;
  }
};

// The W*W scan: each thread scores candidates k = t, t + T, ... by
// summing the row's matching weights with j ascending.
template <int W, class Row, class Out>
__device__ __forceinline__ void plp_score_rows_scan(const Row& src, uint32_t seed,
                                               float scale, int sentinel,
                                               long long first, long long end,
                                               const Out& out) {
  constexpr int T = RowGroup<W>::T;
  constexpr int RPB = RowGroup<W>::RPB;
  __shared__ int s_lab[RPB][W];
  __shared__ float s_w[RPB][W];
  __shared__ float s_best[RPB][T];
  __shared__ int s_id[RPB][T];

  const int sub = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long r = first + sub;
  const bool live = r < end;

  // the row's key is loaded before the staging, so its latency overlaps it
  const int key = live ? src.key(r) : sentinel;
  if (live) {
    for (int k = t; k < W; k += T) src.stage(r, k, W, s_lab[sub][k], s_w[sub][k]);
  }
  __syncthreads();

  const uint32_t row_n = static_cast<uint32_t>(key);
  float best = -INFINITY;
  int best_id = INT_MAX;
  if (live) {
    for (int k = t; k < W; k += T) {
      const int lk = s_lab[sub][k];
      if (lk == sentinel) continue;
      float score = 0.0f;
      for (int j = 0; j < W; ++j)
        if (s_lab[sub][j] == lk) score = __fadd_rn(score, s_w[sub][j]);
      const float eff = __fadd_rn(
          score, tie_noise(row_n, static_cast<uint32_t>(lk), seed, scale));
      argmax_combine(best, best_id, eff, lk);
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
    best_id = s_id[sub][0];
    const int cur = src.cur(r, key);
    float cur_sum = 0.0f;
    bool present = false;
    for (int j = 0; j < W; ++j) {
      const int lj = s_lab[sub][j];
      if (lj != sentinel && lj == cur) {
        cur_sum = __fadd_rn(cur_sum, s_w[sub][j]);
        present = true;
      }
    }
    const float cur_score =
        present ? __fadd_rn(cur_sum, tie_noise(row_n, static_cast<uint32_t>(cur),
                                               seed, scale))
                : 0.0f;
    out(r, best > -INFINITY ? best_id : -1, best, cur_score);
  }
}

// Sort-and-run: the row's slots are sorted by (label, position) and each
// label's run is summed once, by the thread that holds its first slot,
// which also adds the tie noise and offers the label to the argmax; the
// run of the current label gives its sum.  Only the prefix of the row up
// to its last valid slot, rounded up to a power of two, is sorted.
template <int W, class Row, class Out>
__device__ __forceinline__ void plp_score_rows_sorted(
    const Row& src, uint32_t seed, float scale, int sentinel,
    long long first, long long end, const Out& out) {
  constexpr int T = RowGroup<W>::T;
  constexpr int RPB = RowGroup<W>::RPB;
  __shared__ int s_lab[RPB][W];
  __shared__ unsigned short s_pos[RPB][W];
  __shared__ float s_w[RPB][W];
  __shared__ float s_best[RPB][T];
  __shared__ int s_id[RPB][T];
  __shared__ int s_len[RPB];       // 1 + the row's last valid slot
  __shared__ int s_cur[RPB];       // the row's current label
  __shared__ float s_cur_sum[RPB];
  __shared__ int s_present[RPB];
  __shared__ int s_len_block;

  const int sub = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long r = first + sub;
  const bool live = r < end;
  if (t == 0) {
    s_len[sub] = 0;
    s_present[sub] = 0;
  }
  if (threadIdx.x == 0) s_len_block = 0;

  // the row's key is loaded before the staging, so its latency overlaps it
  const int key = live ? src.key(r) : sentinel;
  int last = -1;
  if (live) {
    for (int k = t; k < W; k += T) {
      src.stage(r, k, W, s_lab[sub][k], s_w[sub][k]);
      s_pos[sub][k] = static_cast<unsigned short>(k);
      if (s_lab[sub][k] != sentinel) last = k;
    }
    if (t == 0) s_cur[sub] = src.cur(r, key);
  }
  __syncthreads();
  if (last >= 0) {
    atomicMax(&s_len[sub], last + 1);
    atomicMax(&s_len_block, last + 1);
  }
  __syncthreads();
  const int P = pow2_ceil(s_len[sub]);
  sort_row<W, T>(s_lab[sub], s_pos[sub], s_w[sub], P,
                 pow2_ceil(s_len_block), t, sentinel);

  const uint32_t row_n = static_cast<uint32_t>(key);
  float best = -INFINITY;
  int best_id = INT_MAX;
  if (live) {
    const int cur = s_cur[sub];
    for (int p = t; p < P; p += T) {
      const int lk = s_lab[sub][p];
      if (lk == sentinel) break;                 // sentinels sort last
      if (p > 0 && s_lab[sub][p - 1] == lk) continue;  // not a run's head
      const int end = run_end(s_lab[sub], p, P, lk);
      float score = 0.0f;
#pragma unroll 4
      for (int q = p; q < end; ++q) score = __fadd_rn(score, s_w[sub][q]);
      const float eff = __fadd_rn(
          score, tie_noise(row_n, static_cast<uint32_t>(lk), seed, scale));
      argmax_combine(best, best_id, eff, lk);
      if (lk == cur) {
        s_cur_sum[sub] = score;
        s_present[sub] = 1;
      }
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
    best_id = s_id[sub][0];
    const int cur = s_cur[sub];
    const float cur_score =
        s_present[sub]
            ? __fadd_rn(s_cur_sum[sub],
                        tie_noise(row_n, static_cast<uint32_t>(cur), seed,
                                  scale))
            : 0.0f;
    out(r, best > -INFINITY ? best_id : -1, best, cur_score);
  }
}

// Scores rows first + (threadIdx.x / T) of the flat tiles, those below
// `end`; every thread of the block calls it (it synchronises the block).
// Narrow rows take the scan, wider ones the sort (kScanMaxWidth); both give
// the same bits.
template <int W, class Row, class Out>
__device__ __forceinline__ void plp_score_rows(const Row& src, uint32_t seed,
                                               float scale, int sentinel,
                                               long long first, long long end,
                                               const Out& out) {
  if constexpr (W <= kScanMaxWidth)
    plp_score_rows_scan<W>(src, seed, scale, sentinel, first, end, out);
  else
    plp_score_rows_sorted<W>(src, seed, scale, sentinel, first, end, out);
}

// The PLP move of one W = 16 row held by one lane (common.cuh lane_rows):
// its slot ids and weights in registers, `labels` the block's window of
// the label table, v the row's (real) id.  Each slot's label scores the
// block path's scan sum — the weights of the slots holding it, j
// ascending, from 0.0f — plus its tie noise, and the argmax over the slots
// keeps the best, ties to the smaller label (a total order on non-NaN
// scores, so the order of the slots does not matter).  The current
// label's score is that of a slot holding it: the same sum, the same
// noise.
template <class Labels>
__device__ __forceinline__ void plp_score_lane(const Labels& labels,
                                               uint32_t seed, float scale,
                                               int sentinel, long long r,
                                               int v, const int (&id)[16],
                                               const float (&wt)[16],
                                               const PlpProposal& out) {
  int lab[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) lab[k] = id[k] < sentinel ? labels(id[k]) : sentinel;
  const int cur = labels(v);
  const uint32_t row_n = static_cast<uint32_t>(v);
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

}  // namespace repro_torch
