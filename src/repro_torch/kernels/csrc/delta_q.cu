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
// Each candidate's S is the fold of its slots' weights from 0.0f in
// ascending position, and every gain goes through louvain_gain
// (local_move_louvain.cuh), as in the fused local_move_louvain kernels, so
// the two-step path and the fused kernels agree bit for bit on any
// weights.  Every valid slot scores its gain from its own volume and size.
// `inv_vol` points to the float32 1/vol(V) on the device, so a launch needs
// no host readback.
//
// Paths by width (tile_scoring.cuh), each picked by tools/ab_kernels.py
// delta_q against the block path this kernel took before, on the
// as-skitter stand-in's bucket shapes, six input sets and both singleton
// rules (NVIDIA H100 80GB HBM3, 700 W; ms, block path -> this path;
// PERF.md section 6):
//   width <= 16          a lane a row (louvain_tile_lane), 128 threads a
//                        block: 0.161-0.172 -> 0.080-0.081 (810 488 rows);
//   16 < width <= 1024   a warp a row: pass 1 folds the row into the
//                        warp's hash table of running sums and keeps each
//                        slot's bucket; pass 2 scores every valid slot
//                        other than A from its bucket's S, S_A being A's
//                        bucket (instantiations 64, 256, 1024):
//                        W = 64    0.159-0.200 -> 0.081-0.111 (118 136 rows),
//                        W = 256   0.316-0.442 -> 0.110-0.171 (54 888),
//                        W = 1024  0.522-0.792 -> 0.407-0.625 (25 624);
//                        a warp's register sort with run sums (the resident
//                        Louvain kernel's W = 64 path) took 0.8-1.2x this
//                        path's first version's time at W = 64, 0.9-2.4x
//                        at 256 and 1.0-5.9x at 1024;
//   1024 < width <= 2048  the fused kernels' block path
//                        (local_move_louvain.cuh louvain_score_rows:
//                        sort-and-run), which no bucket of the smoke reaches.
//
// Bound on the H100: bytes.  The function reads the 16*R*width bytes of the
// four tiles and 16*R of the row terms, and writes 8*R; the hash table
// spends O(width) operations a row, far below that bytes term.
// 2048 is the widest power of two whose row staging on the block path
// (32 KB of candidates, weights, volumes and sizes, 2 KB of argmax
// scratch) fits the 48 KB of static shared memory a block gets without an
// opt-in.
#include "tile_scoring.cuh"

namespace {

using repro_torch::LouvainGain;
using repro_torch::LouvainRowTerms;
using repro_torch::LouvainTiles;
using repro_torch::RowGroup;
using repro_torch::SumTable;
using repro_torch::WarpRows;
using repro_torch::kFullWarp;
using repro_torch::kLocalMoveThreads;

constexpr int kLaneThreads = 128;

__global__ void __launch_bounds__(kLaneThreads)
delta_q_lanes(const int* __restrict__ cand, const float* __restrict__ w,
              const float* __restrict__ vol_cand,
              const int* __restrict__ size_cand,
              const int* __restrict__ cur_com, const float* __restrict__ deg_v,
              const float* __restrict__ vol_cur,
              const int* __restrict__ size_cur,
              const float* __restrict__ inv_vol_ptr, int width,
              int singleton_rule, int sentinel, long long n_rows, bool vec,
              int* __restrict__ out_cand, float* __restrict__ out_gain) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kLaneThreads + threadIdx.x;
  if (r >= n_rows) return;
  const LouvainRowTerms a{__ldg(cur_com + r), __ldg(deg_v + r),
                          __ldg(vol_cur + r), __ldg(size_cur + r)};
  int c[16], sz[16];
  float wt[16], vol[16];
  repro_torch::load_tile_row16(cand, r, width, vec, sentinel, c);
  repro_torch::load_tile_row16(w, r, width, vec, 0.0f, wt);
  repro_torch::load_tile_row16(vol_cand, r, width, vec, 0.0f, vol);
  repro_torch::load_tile_row16(size_cand, r, width, vec, 0, sz);
  repro_torch::louvain_tile_lane(c, wt, vol, sz, a, __ldg(inv_vol_ptr),
                                 singleton_rule, sentinel, r,
                                 LouvainGain{out_cand, out_gain});
}

struct VolSize {
  float vol;
  int size;
};

template <int W>
__global__ void __launch_bounds__(WarpRows<W>::kThreads)
delta_q_warps(const int* __restrict__ cand, const float* __restrict__ w,
              const float* __restrict__ vol_cand,
              const int* __restrict__ size_cand,
              const int* __restrict__ cur_com, const float* __restrict__ deg_v,
              const float* __restrict__ vol_cur,
              const int* __restrict__ size_cur,
              const float* __restrict__ inv_vol_ptr, int width,
              int singleton_rule, int sentinel, long long n_rows,
              int* __restrict__ out_cand, float* __restrict__ out_gain) {
  using WR = WarpRows<W>;
  constexpr int kWarps = WR::kWarps;
  constexpr int G = WR::template group<8>;
  __shared__ int s_key[kWarps][2 * W];
  __shared__ float s_sum[kWarps][2 * W];
  __shared__ unsigned char s_claim[kWarps][4 * W];
  __shared__ __align__(16) float s_wbuf[kWarps][64];
  __shared__ unsigned short s_slot[kWarps][W];   // each slot's bucket
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const SumTable<W> t{s_key[wid], s_sum[wid], nullptr, s_claim[wid],
                      s_wbuf[wid]};
  unsigned short* slot = s_slot[wid];
  const float inv_vol = __ldg(inv_vol_ptr);
  repro_torch::init_table(t, sentinel, lane);
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + wid;
       r < n_rows; r += step) {
    const LouvainRowTerms a{__ldg(cur_com + r), __ldg(deg_v + r),
                            __ldg(vol_cur + r), __ldg(size_cur + r)};
    const long long off = r * width;
    // 8 chunks a group: 4 was up to 11 % slower at W = 256 and 1024, 3-4 %
    // faster only on rows of runs (tools/ab_kernels.py, PERF.md section 6)
    repro_torch::fold_row<W, G>(t, cand, w, off, width, sentinel, lane, slot);
    float sa = 0.0f;                  // S_A: A's bucket, if A is present
    if (a.cur != sentinel) {
      const int b = t.find(a.cur, sentinel);
      if (t.key[b] == a.cur) sa = t.sum[b];
    }
    float best = -INFINITY;
    int best_id = INT_MAX;
    repro_torch::chunk_groups<WR::E, G, VolSize>(
        width,
        [&](int c) {
          const int k = 32 * c + lane;
          return k < width ? VolSize{__ldg(vol_cand + off + k),
                                     __ldg(size_cand + off + k)}
                           : VolSize{0.0f, 0};
        },
        [&](int c0, const VolSize (&x)[G], int nc) {
#pragma unroll
          for (int e = 0; e < G; ++e) {
            if (e >= nc) break;
            const int b = slot[32 * (c0 + e) + lane];
            if (b == 0xffff) continue;              // padding
            const int ck = t.key[b];
            if (ck == a.cur) continue;              // is_A
            if (repro_torch::singleton_blocked(a, ck, x[e].size,
                                               singleton_rule))
              continue;
            repro_torch::argmax_combine(
                best, best_id,
                repro_torch::louvain_gain(a, ck, t.sum[b], sa, x[e].vol,
                                          x[e].size, inv_vol, singleton_rule),
                ck);
          }
        });
    repro_torch::warp_argmax(best, best_id);
    if (lane == 0) {
      out_cand[r] = best > -INFINITY ? best_id : -1;
      out_gain[r] = best;
    }
    repro_torch::clear_slots(t, slot, width, sentinel, lane);
  }
}

template <int W>
__global__ void __launch_bounds__(kLocalMoveThreads)
delta_q_block(const int* __restrict__ cand, const float* __restrict__ w,
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

int launch_lanes(const int* cand, const float* w, const float* vol_cand,
                 const int* size_cand, const int* cur_com, const float* deg_v,
                 const float* vol_cur, const int* size_cur,
                 const float* inv_vol, int width, int singleton_rule,
                 int sentinel, long long n_rows, int* out_cand,
                 float* out_gain, cudaStream_t stream) {
  const bool vec = width == 16 && repro_torch::aligned16(cand) &&
                   repro_torch::aligned16(w) &&
                   repro_torch::aligned16(vol_cand) &&
                   repro_torch::aligned16(size_cand);
  const long long blocks = (n_rows + kLaneThreads - 1) / kLaneThreads;
  delta_q_lanes<<<static_cast<unsigned>(blocks), kLaneThreads, 0, stream>>>(
      cand, w, vol_cand, size_cand, cur_com, deg_v, vol_cur, size_cur,
      inv_vol, width, singleton_rule, sentinel, n_rows, vec, out_cand,
      out_gain);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_warps(const int* cand, const float* w, const float* vol_cand,
                 const int* size_cand, const int* cur_com, const float* deg_v,
                 const float* vol_cur, const int* size_cur,
                 const float* inv_vol, int width, int singleton_rule,
                 int sentinel, long long n_rows, int* out_cand,
                 float* out_gain, cudaStream_t stream) {
  unsigned blocks = 0;
  const int err = repro_torch::warp_blocks(
      WarpRows<W>::kThreads, WarpRows<W>::kWarps, n_rows, blocks);
  if (err) return err;
  delta_q_warps<W><<<blocks, WarpRows<W>::kThreads, 0, stream>>>(
      cand, w, vol_cand, size_cand, cur_com, deg_v, vol_cur, size_cur,
      inv_vol, width, singleton_rule, sentinel, n_rows, out_cand, out_gain);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_block(const int* cand, const float* w, const float* vol_cand,
                 const int* size_cand, const int* cur_com, const float* deg_v,
                 const float* vol_cur, const int* size_cur,
                 const float* inv_vol, int width, int singleton_rule,
                 int sentinel, long long n_rows, int* out_cand,
                 float* out_gain, cudaStream_t stream) {
  constexpr int RPB = RowGroup<W>::RPB;
  const long long blocks = (n_rows + RPB - 1) / RPB;
  delta_q_block<W><<<static_cast<unsigned>(blocks), kLocalMoveThreads, 0,
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
#define REPRO_ARGS                                                             \
  cand, w, vol_cand, size_cand, cur_com, deg_v, vol_cur, size_cur, inv_vol,    \
      width, singleton_rule, sentinel, n_rows, out_cand, out_gain, s
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (width <= 16) return launch_lanes(REPRO_ARGS);
  if (width <= 64) return launch_warps<64>(REPRO_ARGS);
  if (width <= 256) return launch_warps<256>(REPRO_ARGS);
  if (width <= 1024) return launch_warps<1024>(REPRO_ARGS);
  if (width <= 2048) return launch_block<2048>(REPRO_ARGS);
#undef REPRO_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
