// PLP row scoring shared by the resident kernel (local_move_plp.cu) and the
// streamed kernel (local_move_plp_streamed.cu); they differ only in where
// the label table is read (a DeviceTable or a WindowTable, common.cuh).
//
// Per row r (vertex rows[r], neighbors nbr[r, :W], weights w[r, :W]):
//   lab_k  = labels(nbr_k)   (sentinel ids keep the sentinel, never read)
//   score  = sum_j w_j [lab_j == lab_k] + tie_noise(row, lab_k)
//   best   = argmax over valid k, ties to the smaller label
//   cur    = sum_j w_j [lab_j == labels(row)] + noise, or 0 if absent
//   out    = (best label or -1, best > cur)
//
// A row's labels and weights are staged once in shared memory (8 KB at
// W = 1024), so the W*W loop reads only shared memory.  Each thread scores
// candidates k = t, t + T, ... with j ascending; a shared-memory tree takes
// the row's argmax.
#pragma once
#include <climits>
#include <cmath>

#include "common.cuh"

namespace repro_torch {

// Scores rows first + (threadIdx.x / T) of the flat tiles, those below
// `end`; every thread of the block calls it (it synchronises the block).
template <int W, class Labels>
__device__ __forceinline__ void plp_score_rows(
    const int* __restrict__ rows, const int* __restrict__ nbr,
    const float* __restrict__ w, const Labels& labels, uint32_t seed,
    float scale, int sentinel, long long first, long long end,
    int* __restrict__ out_best, unsigned char* __restrict__ out_prop) {
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

  if (live) {
    const long long base = r * W;
    for (int k = t; k < W; k += T) {
      const int v = nbr[base + k];
      s_lab[sub][k] = v < sentinel ? labels(v) : sentinel;
      s_w[sub][k] = w[base + k];
    }
  }
  __syncthreads();

  const int row = live ? rows[r] : sentinel;
  const uint32_t row_n = static_cast<uint32_t>(row < sentinel ? row : sentinel);
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
    const int cur = row < sentinel ? labels(row) : sentinel;
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
    const int lab = best > -INFINITY ? best_id : -1;
    out_best[r] = lab;
    out_prop[r] = (lab >= 0 && best > cur_score) ? 1 : 0;
  }
}

}  // namespace repro_torch
