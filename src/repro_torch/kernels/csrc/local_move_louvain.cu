// local_move_louvain: fused gather + Louvain Eq. 1 delta-Q argmax per ELL row.
//
// Replaces src/repro/kernels/local_move/kernel.py local_move_louvain_pallas
// (body _local_move_louvain_kernel) in its resident-table form.  Plain
// version: src/repro_torch/kernels/local_move/ref.py
// local_move_louvain_tables_ref.
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
// Bound on the H100: W*W compares per row against 16*W bytes of tile and
// gathered table entries, so rows of width >= 64 are bound by operations
// and the W = 16 bucket by bytes.  Design: candidates, weights, volumes and
// sizes of a row are staged once in shared memory (16 KB at W = 1024); the
// four tables are read from device memory through L2 (no counterpart of the
// TPU's VMEM-resident copies); narrow rows pack into one 256-thread block.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

using repro_torch::argmax_combine;

constexpr int kThreads = 256;

template <int W>
__global__ void __launch_bounds__(kThreads)
louvain_kernel(const int* __restrict__ rows, const int* __restrict__ nbr,
               const float* __restrict__ w, const int* __restrict__ com_v,
               const float* __restrict__ volcom_v,
               const int* __restrict__ sizecom_v,
               const float* __restrict__ deg_v,
               const float* __restrict__ inv_vol_ptr, int singleton_rule,
               int sentinel, long long n_rows, int* __restrict__ out_best,
               unsigned char* __restrict__ out_prop) {
  constexpr int T = W < kThreads ? W : kThreads;  // threads per row
  constexpr int RPB = kThreads / T;               // rows per block
  __shared__ int s_cand[RPB][W];
  __shared__ float s_w[RPB][W];
  __shared__ float s_vol[RPB][W];
  __shared__ int s_size[RPB][W];
  __shared__ float s_best[RPB][T];
  __shared__ int s_id[RPB][T];
  __shared__ float s_sa[RPB];

  const int sub = threadIdx.x / T;
  const int t = threadIdx.x % T;
  const long long r = static_cast<long long>(blockIdx.x) * RPB + sub;
  const bool live = r < n_rows;

  if (live) {
    const long long base = r * W;
    for (int k = t; k < W; k += T) {
      const int v = nbr[base + k];
      const bool real = v < sentinel;
      s_cand[sub][k] = real ? com_v[v] : sentinel;
      s_vol[sub][k] = real ? volcom_v[v] : 0.0f;
      s_size[sub][k] = real ? sizecom_v[v] : 0;
      s_w[sub][k] = w[base + k];
    }
  }
  const int row = live ? rows[r] : sentinel;
  const bool row_real = row < sentinel;
  const int cur = row_real ? com_v[row] : sentinel;
  const float deg = row_real ? deg_v[row] : 0.0f;
  const float vol_cur = row_real ? volcom_v[row] : 0.0f;
  const int size_cur = row_real ? sizecom_v[row] : 0;
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
    const float inv_vol = *inv_vol_ptr;
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

template <int W>
void launch(const int* rows, const int* nbr, const float* w, const int* com_v,
            const float* volcom_v, const int* sizecom_v, const float* deg_v,
            const float* inv_vol, int singleton_rule, int sentinel,
            long long n_rows, int* out_best, unsigned char* out_prop,
            cudaStream_t stream) {
  constexpr int RPB = kThreads / (W < kThreads ? W : kThreads);
  const long long blocks = (n_rows + RPB - 1) / RPB;
  louvain_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      rows, nbr, w, com_v, volcom_v, sizecom_v, deg_v, inv_vol, singleton_rule,
      sentinel, n_rows, out_best, out_prop);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  W must be one of the
// ELL bucket widths 16, 64, 256, 1024; `inv_vol` points to the float32
// 1/vol(V) on the device, so a launch needs no host readback.
extern "C" int local_move_louvain_launch(
    const int* rows, const int* nbr, const float* w, const int* com_v,
    const float* volcom_v, const int* sizecom_v, const float* deg_v,
    const float* inv_vol, int singleton_rule, int sentinel, long long n_rows,
    int width, int* out_best, unsigned char* out_prop, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(WIDTH)                                                    \
  launch<WIDTH>(rows, nbr, w, com_v, volcom_v, sizecom_v, deg_v, inv_vol,      \
                singleton_rule, sentinel, n_rows, out_best, out_prop, s)
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
