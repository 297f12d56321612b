// Louvain row scoring shared by the resident kernel (local_move_louvain.cu)
// and the streamed kernel (local_move_louvain_streamed.cu); they differ
// only in where the four tables are read (DeviceTable or WindowTable,
// common.cuh).
//
// Per row r (vertex v = rows[r]) on the per-VERTEX composed tables
// (com_v, volcom_v, sizecom_v, deg_v; ref.compose_louvain_tables):
//   cand_k = com_v[nbr_k], S_k = sum_j w_j [cand_j == cand_k]
//   A = com_v[v], S_A = sum_j w_j [valid_j and cand_j == A]
//   gain_k = (S_k - S_A) - deg * ((volB_k - volA) * inv_vol)
//     volB_k = volcom_v[nbr_k] - [cand_k == A] deg,  volA = volcom_v[v] - deg
//   singleton rule: -inf when size(A) == size(cand_k) == 1 and cand_k > A
//   out = (argmax over valid k with cand_k != A, ties to the smaller id,
//          or -1; best gain > 0)
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

// Scores rows first + (threadIdx.x / T) of the flat tiles, those below
// `end`; every thread of the block calls it (it synchronises the block).
template <int W, class Ints, class Floats>
__device__ __forceinline__ void louvain_score_rows(
    const int* __restrict__ rows, const int* __restrict__ nbr,
    const float* __restrict__ w, const Ints& com_v, const Floats& volcom_v,
    const Ints& sizecom_v, const Floats& deg_v, float inv_vol,
    int singleton_rule, int sentinel, long long first, long long end,
    int* __restrict__ out_best, unsigned char* __restrict__ out_prop) {
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
    const long long base = r * W;
    for (int k = t; k < W; k += T) {
      const int v = nbr[base + k];
      const bool real = v < sentinel;
      s_cand[sub][k] = real ? com_v(v) : sentinel;
      s_vol[sub][k] = real ? volcom_v(v) : 0.0f;
      s_size[sub][k] = real ? sizecom_v(v) : 0;
      s_w[sub][k] = w[base + k];
    }
  }
  const int row = live ? rows[r] : sentinel;
  const bool row_real = row < sentinel;
  const int cur = row_real ? com_v(row) : sentinel;
  const float deg = row_real ? deg_v(row) : 0.0f;
  const float vol_cur = row_real ? volcom_v(row) : 0.0f;
  const int size_cur = row_real ? sizecom_v(row) : 0;
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
    const float vol_a_minus = __fsub_rn(vol_cur, deg);
    for (int k = t; k < W; k += T) {
      const int ck = s_cand[sub][k];
      if (ck == sentinel || ck == cur) continue;  // invalid or is_A
      if (singleton_rule && size_cur == 1 && s_size[sub][k] == 1 && ck > cur)
        continue;                                  // gain = -inf
      float s_k = 0.0f;
      for (int j = 0; j < W; ++j)
        if (s_cand[sub][j] == ck) s_k = __fadd_rn(s_k, s_w[sub][j]);
      // ck != cur, so vol(B-) = volcom - 0
      const float vol_b_minus = __fsub_rn(s_vol[sub][k], 0.0f);
      const float gain = __fsub_rn(
          __fsub_rn(s_k, sa),
          __fmul_rn(deg, __fmul_rn(__fsub_rn(vol_b_minus, vol_a_minus), inv_vol)));
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
    const int cand = best > -INFINITY ? s_id[sub][0] : -1;
    out_best[r] = cand;
    out_prop[r] = (cand >= 0 && best > 0.0f) ? 1 : 0;
  }
}

}  // namespace repro_torch
