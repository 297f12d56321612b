// delta_q: Louvain Eq. 1 delta-Q + singleton rule + argmax over
// PRE-GATHERED candidate tiles (the scoring half of the two-step path: the
// caller gathers the (R, width) candidate-community, volume and size tiles,
// this kernel scores them).
//
// Replaces src/repro/kernels/delta_q/kernel.py delta_q_pallas (body
// _delta_q_kernel).  Plain version: src/repro_torch/kernels/delta_q/ref.py
// delta_q_ref.
//
//   gain_k = (S(cand_k) - S_A) - deg * ((vol(B-)_k - vol(A-)) * inv_vol)
//   out    = (argmax over valid k with cand_k != cur, ties to the smaller
//             id, or -1; the best gain or -inf)
//
// The row scoring is local_move_louvain.cuh, the fused local_move_louvain
// kernels' own code with the tiles as its row source, so the two-step path
// and the fused kernels add and round the same floats in the same order and
// agree bit for bit on any weights.  `inv_vol` points to the float32
// 1/vol(V) on the device, so a launch needs no host readback.
//
// Bound on the H100: bytes.  The function reads the 16*R*width bytes of the
// four tiles and 16*R of the row terms, and writes 8*R; a sort-based count
// of the compares it needs stays below that bytes term.  This kernel spends
// width^2 compares per row instead, as the fused kernels do.
// Widths: the four ELL widths 16, 64, 256, 1024 and the widest row, 2048,
// have an instantiation each; any other width up to 2048 runs in the next
// wider one, its staging padded with the sentinel (which no candidate
// equals).  2048 is the widest power of two whose row staging (32 KB of
// candidates, weights, volumes and sizes, 2 KB of argmax scratch) fits the
// 48 KB of static shared memory a block gets without an opt-in.
#include "local_move_louvain.cuh"

namespace {

using repro_torch::LouvainGain;
using repro_torch::LouvainTiles;
using repro_torch::RowGroup;
using repro_torch::kLocalMoveThreads;

template <int W>
__global__ void __launch_bounds__(kLocalMoveThreads)
delta_q_kernel(const int* __restrict__ cand, const float* __restrict__ w,
               const float* __restrict__ vol_cand,
               const int* __restrict__ size_cand,
               const int* __restrict__ cur_com, const float* __restrict__ deg_v,
               const float* __restrict__ vol_cur,
               const int* __restrict__ size_cur,
               const float* __restrict__ inv_vol_ptr, int width,
               int singleton_rule, int sentinel, long long n_rows,
               int* __restrict__ out_cand, float* __restrict__ out_gain) {
  const long long first = static_cast<long long>(blockIdx.x) * RowGroup<W>::RPB;
  repro_torch::louvain_score_rows<W>(
      LouvainTiles{cand, w, vol_cand, size_cand, cur_com, deg_v, vol_cur,
                   size_cur, width, sentinel},
      *inv_vol_ptr, singleton_rule, sentinel, first, n_rows,
      LouvainGain{out_cand, out_gain});
}

template <int W>
int launch(const int* cand, const float* w, const float* vol_cand,
           const int* size_cand, const int* cur_com, const float* deg_v,
           const float* vol_cur, const int* size_cur, const float* inv_vol,
           int width, int singleton_rule, int sentinel, long long n_rows,
           int* out_cand, float* out_gain, cudaStream_t stream) {
  constexpr int RPB = RowGroup<W>::RPB;
  const long long blocks = (n_rows + RPB - 1) / RPB;
  delta_q_kernel<W><<<static_cast<unsigned>(blocks), kLocalMoveThreads, 0,
                      stream>>>(cand, w, vol_cand, size_cand, cur_com, deg_v,
                                vol_cur, size_cur, inv_vol, width,
                                singleton_rule, sentinel, n_rows, out_cand,
                                out_gain);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  The tiles are
// (n_rows, width) row-major, 1 <= width <= 2048; the row terms are (n_rows,).
extern "C" int delta_q_launch(const int* cand, const float* w,
                              const float* vol_cand, const int* size_cand,
                              const int* cur_com, const float* deg_v,
                              const float* vol_cur, const int* size_cur,
                              const float* inv_vol, int singleton_rule,
                              int sentinel, long long n_rows, int width,
                              int* out_cand, float* out_gain, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(WIDTH)                                                    \
  return launch<WIDTH>(cand, w, vol_cand, size_cand, cur_com, deg_v, vol_cur,  \
                       size_cur, inv_vol, width, singleton_rule, sentinel,     \
                       n_rows, out_cand, out_gain, s)
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (width <= 16) REPRO_LAUNCH(16);
  if (width <= 64) REPRO_LAUNCH(64);
  if (width <= 256) REPRO_LAUNCH(256);
  if (width <= 1024) REPRO_LAUNCH(1024);
  if (width <= 2048) REPRO_LAUNCH(2048);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
