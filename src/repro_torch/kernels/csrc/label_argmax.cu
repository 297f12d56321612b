// label_argmax: PLP weighted-label-mode scoring over PRE-GATHERED tiles (the
// scoring half of the two-step path: the caller gathers the (R, width)
// neighbour-label tile, this kernel scores it).
//
// Replaces src/repro/kernels/label_argmax/kernel.py label_argmax_pallas
// (body _label_argmax_kernel).  Plain version:
// src/repro_torch/kernels/label_argmax/ref.py label_argmax_ref.
//
//   score(c)  = sum_k w[r,k] [lab[r,k] == c] + tie_noise(rows[r], c)
//   best      = argmax over the row's valid labels (ties to the smaller)
//   cur_score = score(cur_lab[r]) if cur_lab[r] is among them, else 0
//   out       = (best label or -1, best score or -inf, cur_score)
//
// The row scoring is local_move_plp.cuh, the fused local_move_plp kernels'
// own code with the tile as its row source, so the two-step path
// (gather, then this kernel) and the fused kernels add the same floats in
// the same order and agree bit for bit on any weights.
//
// Bound on the H100: bytes.  The function reads the 8*R*width bytes of the
// two tiles and 8*R of cur_lab and rows, and writes 12*R; a sort-based
// count of the compares it needs (log2 width per entry) stays below that
// bytes term.  This kernel spends width^2 compares per row instead, as the
// fused kernels do.
// Widths: the four ELL widths 16, 64, 256, 1024 and the widest row, 4096,
// have an instantiation each; any other width up to 4096 runs in the next
// wider one, its staging padded with the sentinel (which scores nothing).
// 4096 is the widest power of two whose row staging (32 KB of labels and
// weights, 2 KB of argmax scratch) fits the 48 KB of static shared memory a
// block gets without an opt-in.
#include "local_move_plp.cuh"

namespace {

using repro_torch::PlpScores;
using repro_torch::PlpTiles;
using repro_torch::RowGroup;
using repro_torch::kLocalMoveThreads;

template <int W>
__global__ void __launch_bounds__(kLocalMoveThreads)
label_argmax_kernel(const int* __restrict__ nbr_lab,
                    const float* __restrict__ nbr_w,
                    const int* __restrict__ cur_lab,
                    const int* __restrict__ rows, int width, uint32_t seed,
                    float scale, int sentinel, long long n_rows,
                    int* __restrict__ out_lab, float* __restrict__ out_best,
                    float* __restrict__ out_cur) {
  const long long first = static_cast<long long>(blockIdx.x) * RowGroup<W>::RPB;
  repro_torch::plp_score_rows<W>(
      PlpTiles{nbr_lab, nbr_w, cur_lab, rows, width, sentinel}, seed, scale,
      sentinel, first, n_rows, PlpScores{out_lab, out_best, out_cur});
}

template <int W>
int launch(const int* nbr_lab, const float* nbr_w, const int* cur_lab,
           const int* rows, int width, uint32_t seed, float scale,
           int sentinel, long long n_rows, int* out_lab, float* out_best,
           float* out_cur, cudaStream_t stream) {
  constexpr int RPB = RowGroup<W>::RPB;
  const long long blocks = (n_rows + RPB - 1) / RPB;
  label_argmax_kernel<W><<<static_cast<unsigned>(blocks), kLocalMoveThreads, 0,
                           stream>>>(nbr_lab, nbr_w, cur_lab, rows, width, seed,
                                     scale, sentinel, n_rows, out_lab, out_best,
                                     out_cur);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  The tiles are
// (n_rows, width) row-major, 1 <= width <= 4096; `scale` is the float32
// value of tie_eps / 2^32.
extern "C" int label_argmax_launch(const int* nbr_lab, const float* nbr_w,
                                   const int* cur_lab, const int* rows,
                                   unsigned int seed, float scale, int sentinel,
                                   long long n_rows, int width, int* out_lab,
                                   float* out_best, float* out_cur,
                                   void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(WIDTH)                                                   \
  return launch<WIDTH>(nbr_lab, nbr_w, cur_lab, rows, width, seed, scale,     \
                       sentinel, n_rows, out_lab, out_best, out_cur, s)
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (width <= 16) REPRO_LAUNCH(16);
  if (width <= 64) REPRO_LAUNCH(64);
  if (width <= 256) REPRO_LAUNCH(256);
  if (width <= 1024) REPRO_LAUNCH(1024);
  if (width <= 4096) REPRO_LAUNCH(4096);
#undef REPRO_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
