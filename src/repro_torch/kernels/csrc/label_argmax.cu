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
// Each label's sum is the fold of its slots' weights from 0.0f in
// ascending position, as in the fused local_move_plp kernels, so the
// two-step path (gather, then this kernel) and the fused kernels agree bit
// for bit on any weights.
//
// Paths by width (tile_scoring.cuh), each picked by tools/ab_kernels.py
// label_argmax against the block path this kernel took before, on the
// as-skitter stand-in's bucket shapes and six input sets (NVIDIA H100 80GB
// HBM3, 700 W; ms, block path -> this path; PERF.md section 6):
//   width <= 16          a lane a row (plp_tile_lane), 128 threads a
//                        block: 0.204-0.209 -> 0.045-0.046 (810 488 rows);
//   16 < width <= 1024   a warp a row with a hash table of running sums
//                        (instantiations 64, 256, 1024; resident blocks
//                        walk the rows; the filled buckets scored from the
//                        row's list, then emptied):
//                        W = 64    0.149-0.176 -> 0.077-0.116 (118 136 rows),
//                        W = 256   0.299-0.399 -> 0.103-0.166 (54 888),
//                        W = 1024  0.495-0.682 -> 0.311-0.522 (25 624);
//                        a warp's register sort with run sums (the resident
//                        Louvain kernel's W = 64 path) took 0.8-1.2x this
//                        path's first version's time at W = 64, 0.9-2.4x
//                        at 256 and 1.0-5.9x at 1024;
//   1024 < width <= 4096  the fused kernels' block path
//                        (local_move_plp.cuh plp_score_rows: sort-and-run),
//                        which no bucket of the smoke reaches.
//
// Bound on the H100: bytes.  The function reads the 8*R*width bytes of the
// two tiles and 8*R of cur_lab and rows, and writes 12*R; the hash table
// spends O(width) operations a row, far below that bytes term.
// 4096 is the widest power of two whose row staging on the block path
// (32 KB of labels and weights, 2 KB of argmax scratch) fits the 48 KB of
// static shared memory a block gets without an opt-in.
#include "tile_scoring.cuh"

namespace {

using repro_torch::PlpScores;
using repro_torch::PlpTiles;
using repro_torch::RowGroup;
using repro_torch::SumTable;
using repro_torch::WarpRows;
using repro_torch::kFullWarp;
using repro_torch::kLocalMoveThreads;

constexpr int kLaneThreads = 128;

__global__ void __launch_bounds__(kLaneThreads)
label_argmax_lanes(const int* __restrict__ nbr_lab,
                   const float* __restrict__ nbr_w,
                   const int* __restrict__ cur_lab,
                   const int* __restrict__ rows, int width, uint32_t seed,
                   float scale, int sentinel, long long n_rows, bool vec,
                   int* __restrict__ out_lab, float* __restrict__ out_best,
                   float* __restrict__ out_cur) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kLaneThreads + threadIdx.x;
  if (r >= n_rows) return;
  const int key = __ldg(rows + r);
  const int cur = __ldg(cur_lab + r);
  int lab[16];
  float wt[16];
  repro_torch::load_tile_row16(nbr_lab, r, width, vec, sentinel, lab);
  repro_torch::load_tile_row16(nbr_w, r, width, vec, 0.0f, wt);
  repro_torch::plp_tile_lane(lab, wt, key, cur, seed, scale, sentinel, r,
                             PlpScores{out_lab, out_best, out_cur});
}

template <int W>
__global__ void __launch_bounds__(WarpRows<W>::kThreads)
label_argmax_warps(const int* __restrict__ nbr_lab,
                   const float* __restrict__ nbr_w,
                   const int* __restrict__ cur_lab,
                   const int* __restrict__ rows, int width, uint32_t seed,
                   float scale, int sentinel, long long n_rows,
                   int* __restrict__ out_lab, float* __restrict__ out_best,
                   float* __restrict__ out_cur) {
  constexpr int kWarps = WarpRows<W>::kWarps;
  __shared__ int s_key[kWarps][2 * W];
  __shared__ float s_sum[kWarps][2 * W];
  __shared__ unsigned short s_list[kWarps][W];
  __shared__ unsigned char s_claim[kWarps][4 * W];
  __shared__ __align__(16) float s_wbuf[kWarps][64];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const SumTable<W> t{s_key[wid], s_sum[wid], s_list[wid], s_claim[wid],
                      s_wbuf[wid]};
  repro_torch::init_table(t, sentinel, lane);
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + wid;
       r < n_rows; r += step) {
    const int key = __ldg(rows + r);
    const int cur = __ldg(cur_lab + r);
    // 4 chunks a group: 2-20 % faster than 8 at W = 256 and 1024, but for
    // all-distinct rows at 1024 (+4 %; tools/ab_kernels.py, PERF.md
    // section 6)
    const int n_list = repro_torch::fold_row<W, WarpRows<W>::template group<4>>(
        t, nbr_lab, nbr_w, r * width, width, sentinel, lane, nullptr);
    // each filled bucket scored from the list (a bucket listed twice
    // scores the same label twice), then emptied
    const uint32_t row_n = static_cast<uint32_t>(key);
    float best = -INFINITY, cur_eff = 0.0f;
    int best_id = INT_MAX;
    bool found = false;
    for (int i = lane; i < n_list; i += 32) {
      const int b = t.list[i];
      const int lk = t.key[b];
      const float eff = __fadd_rn(
          t.sum[b], repro_torch::tie_noise(row_n, static_cast<uint32_t>(lk),
                                           seed, scale));
      repro_torch::argmax_combine(best, best_id, eff, lk);
      if (lk == cur) {
        cur_eff = eff;
        found = true;
      }
    }
    repro_torch::clear_list(t, n_list, sentinel, lane);
    repro_torch::warp_argmax(best, best_id);
    const unsigned has = __ballot_sync(kFullWarp, found);
    const float cur_score =
        has ? __shfl_sync(kFullWarp, cur_eff, __ffs(has) - 1) : 0.0f;
    if (lane == 0) {
      out_lab[r] = best > -INFINITY ? best_id : -1;
      out_best[r] = best;
      out_cur[r] = cur_score;
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kLocalMoveThreads)
label_argmax_block(const int* __restrict__ nbr_lab,
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

int launch_lanes(const int* nbr_lab, const float* nbr_w, const int* cur_lab,
                 const int* rows, int width, uint32_t seed, float scale,
                 int sentinel, long long n_rows, int* out_lab, float* out_best,
                 float* out_cur, cudaStream_t stream) {
  const bool vec = width == 16 && repro_torch::aligned16(nbr_lab) &&
                   repro_torch::aligned16(nbr_w);
  const long long blocks = (n_rows + kLaneThreads - 1) / kLaneThreads;
  label_argmax_lanes<<<static_cast<unsigned>(blocks), kLaneThreads, 0,
                       stream>>>(nbr_lab, nbr_w, cur_lab, rows, width, seed,
                                 scale, sentinel, n_rows, vec, out_lab,
                                 out_best, out_cur);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_warps(const int* nbr_lab, const float* nbr_w, const int* cur_lab,
                 const int* rows, int width, uint32_t seed, float scale,
                 int sentinel, long long n_rows, int* out_lab, float* out_best,
                 float* out_cur, cudaStream_t stream) {
  unsigned blocks = 0;
  const int err = repro_torch::warp_blocks(
      WarpRows<W>::kThreads, WarpRows<W>::kWarps, n_rows, blocks);
  if (err) return err;
  label_argmax_warps<W><<<blocks, WarpRows<W>::kThreads, 0, stream>>>(
      nbr_lab, nbr_w, cur_lab, rows, width, seed, scale, sentinel, n_rows,
      out_lab, out_best, out_cur);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_block(const int* nbr_lab, const float* nbr_w, const int* cur_lab,
                 const int* rows, int width, uint32_t seed, float scale,
                 int sentinel, long long n_rows, int* out_lab, float* out_best,
                 float* out_cur, cudaStream_t stream) {
  constexpr int RPB = RowGroup<W>::RPB;
  const long long blocks = (n_rows + RPB - 1) / RPB;
  label_argmax_block<W><<<static_cast<unsigned>(blocks), kLocalMoveThreads, 0,
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
#define REPRO_ARGS                                                           \
  nbr_lab, nbr_w, cur_lab, rows, width, seed, scale, sentinel, n_rows,       \
      out_lab, out_best, out_cur, s
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (width <= 16) return launch_lanes(REPRO_ARGS);
  if (width <= 64) return launch_warps<64>(REPRO_ARGS);
  if (width <= 256) return launch_warps<256>(REPRO_ARGS);
  if (width <= 1024) return launch_warps<1024>(REPRO_ARGS);
  if (width <= 4096) return launch_block<4096>(REPRO_ARGS);
#undef REPRO_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
