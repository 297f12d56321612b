// local_move_plp: fused gather + PLP weighted-label-mode scoring per ELL row.
//
// Replaces src/repro/kernels/local_move/kernel.py local_move_plp_pallas
// (body _local_move_plp_kernel) in its resident-table form.  Plain version:
// src/repro_torch/kernels/local_move/ref.py local_move_plp_ref.
//
// Per row r (vertex rows[r], neighbors nbr[r, :W], weights w[r, :W]):
//   lab_k  = labels[nbr_k]   (sentinel ids keep the sentinel, never read)
//   score  = sum_j w_j [lab_j == lab_k] + tie_noise(row, lab_k)
//   best   = argmax over valid k, ties to the smaller label
//   cur    = sum_j w_j [lab_j == labels[row]] + noise, or 0 if absent
//   out    = (best label or -1, best > cur)
//
// Bound on the H100: the scoring is W*W compares per row against 8*W bytes
// of tile, so rows of width >= 64 are bound by operations and the W = 16
// bucket by the bytes of its tiles and its label gathers.  Design: a row's
// labels and weights are staged once in shared memory (8 KB at W = 1024),
// so the W*W loop reads only shared memory; the label table is read from
// device memory through L2 (the TPU kernel's VMEM-resident table copy has
// no counterpart and no budget here).  Narrow rows pack into one 256-thread
// block (16 rows at W = 16, 4 at W = 64) so a block is never mostly idle.
// Each thread scores candidates k = t, t + T, ... with j ascending; a
// shared-memory tree takes the block's argmax.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

using repro_torch::argmax_combine;
using repro_torch::tie_noise;

constexpr int kThreads = 256;

template <int W>
__global__ void __launch_bounds__(kThreads)
plp_kernel(const int* __restrict__ rows, const int* __restrict__ nbr,
           const float* __restrict__ w, const int* __restrict__ labels,
           uint32_t seed, float scale, int sentinel, long long n_rows,
           int* __restrict__ out_best, unsigned char* __restrict__ out_prop) {
  constexpr int T = W < kThreads ? W : kThreads;  // threads per row
  constexpr int RPB = kThreads / T;               // rows per block
  __shared__ int s_lab[RPB][W];
  __shared__ float s_w[RPB][W];
  __shared__ float s_best[RPB][T];
  __shared__ int s_id[RPB][T];

  const int sub = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long r = static_cast<long long>(blockIdx.x) * RPB + sub;
  const bool live = r < n_rows;

  if (live) {
    const long long base = r * W;
    for (int k = t; k < W; k += T) {
      const int v = nbr[base + k];
      s_lab[sub][k] = v < sentinel ? labels[v] : sentinel;
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
    const int cur = row < sentinel ? labels[row] : sentinel;
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

template <int W>
void launch(const int* rows, const int* nbr, const float* w, const int* labels,
            uint32_t seed, float scale, int sentinel, long long n_rows,
            int* out_best, unsigned char* out_prop, cudaStream_t stream) {
  constexpr int RPB = kThreads / (W < kThreads ? W : kThreads);
  const long long blocks = (n_rows + RPB - 1) / RPB;
  plp_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      rows, nbr, w, labels, seed, scale, sentinel, n_rows, out_best, out_prop);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  W must be one of the
// ELL bucket widths 16, 64, 256, 1024.
extern "C" int local_move_plp_launch(const int* rows, const int* nbr,
                                     const float* w, const int* labels,
                                     unsigned int seed, float scale,
                                     int sentinel, long long n_rows, int width,
                                     int* out_best, unsigned char* out_prop,
                                     void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(WIDTH)                                                    \
  launch<WIDTH>(rows, nbr, w, labels, seed, scale, sentinel, n_rows, out_best, \
                out_prop, s)
  switch (width) {
    case 16: REPRO_LAUNCH(16); break;
    case 64: REPRO_LAUNCH(64); break;
    case 256: REPRO_LAUNCH(256); break;
    case 1024: REPRO_LAUNCH(1024); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
