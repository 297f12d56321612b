// local_move_louvain: fused gather + Louvain Eq. 1 delta-Q argmax per ELL row.
//
// Replaces src/repro/kernels/local_move/kernel.py local_move_louvain_pallas
// (body _local_move_louvain_kernel) in its resident-table form.  Plain
// version: src/repro_torch/kernels/local_move/ref.py
// local_move_louvain_tables_ref.  The row scoring is local_move_louvain.cuh,
// shared with the streamed kernel and the two-step delta_q kernel.
//
// Tile contract (graph/ell.py build_ell and traced_ell_tile): a row whose
// id is the sentinel holds only sentinel slots of weight 0; the plain
// version gives it (-1, no move).  The one-warp-a-row path relies on it: it
// settles such a row from its 4-byte id and reads none of its slots.
//
// Bound on the H100: bytes, at every width.  The function must read each
// row id, each live row's slots up to its last real one, the four tables
// and write the outputs (chip_smoke.py's contract bound); a sort-based
// count of the compares it needs stays below that bytes term (PERF.md
// section 6).  Design: the four tables are read from device memory through
// L2 (no counterpart of the TPU's VMEM-resident copies).  At the widths of
// by_warp() one warp scores one row at a time (louvain_rows_by_warp): no
// block barrier, dead rows skipped, a live row's keys sorted in registers.
// The other widths keep the block path (louvain_score_rows), narrow rows
// packed into one 256-thread block.
#include "local_move_louvain.cuh"

namespace {

using repro_torch::DeviceTable;
using repro_torch::LouvainGathered;
using repro_torch::LouvainProposal;
using repro_torch::RowGroup;
using repro_torch::kLocalMoveThreads;
using Resident = LouvainGathered<DeviceTable<int>, DeviceTable<float>>;

// Widths scored one row per warp (louvain_rows_by_warp); the others keep
// the block path.  Timed on an H100 (700 W; tools/ab_kernels.py
// local_move against the block path): at W = 64 the warp path takes the
// as-skitter stand-in's coarse tile (2^21 rows, half dead) in 0.33 ms
// where the block path takes 1.60, and the level-0 sets in 0.16-0.17
// where it takes 0.19-0.22; at W = 256 it loses 18-27 % on level-0 sets.
// W = 16 is narrower than a warp: it keeps the block path (the scan).
__host__ __device__ constexpr bool by_warp(int W) { return W == 64; }

// Consecutive rows a warp takes: their row ids and then their slot ids are
// loaded together, and the rows with nothing to score written at once.
// Fewer rows a warp keep more warps in flight on an all-live bucket; more
// rows load more of a late coarse level's empty rows at once.  H100, W =
// 64, ms on a level-0 set (`prefix`) / the coarse tile (`traced`) / a late
// coarse tile (`late_coarse`): 4 rows 0.160 / 0.325 / 0.141, 8 rows 0.168
// / 0.334 / 0.138; the rows one at a time at 8 rows a warp (no batched
// slot ids) 0.159 / 0.323 / 0.165; at 16 rows a warp every set is slower
// (a partial second wave of blocks on the level-0 bucket), and without
// the 8-blocks bound (48 warps an SM instead of 64) the coarse tile takes
// 0.41.
constexpr int kWarpRows = 4;
constexpr int kWarpBlockRows = kLocalMoveThreads / 32 * kWarpRows;
constexpr int kWarpMinBlocks = 8;

template <int W>
__global__ void __launch_bounds__(kLocalMoveThreads)
louvain_kernel(const int* __restrict__ rows, const int* __restrict__ nbr,
               const float* __restrict__ w, const int* __restrict__ com_v,
               const float* __restrict__ volcom_v,
               const int* __restrict__ sizecom_v,
               const float* __restrict__ deg_v,
               const float* __restrict__ inv_vol_ptr, int singleton_rule,
               int sentinel, long long n_rows, int* __restrict__ out_best,
               unsigned char* __restrict__ out_prop) {
  const long long first = static_cast<long long>(blockIdx.x) * RowGroup<W>::RPB;
  repro_torch::louvain_score_rows<W>(
      Resident{rows, nbr, w, DeviceTable<int>{com_v},
               DeviceTable<float>{volcom_v}, DeviceTable<int>{sizecom_v},
               DeviceTable<float>{deg_v}, sentinel},
      *inv_vol_ptr, singleton_rule, sentinel, first, n_rows,
      LouvainProposal{out_best, out_prop});
}

template <int W, class K>
__global__ void __launch_bounds__(kLocalMoveThreads, kWarpMinBlocks)
louvain_warp_kernel(const int* __restrict__ rows, const int* __restrict__ nbr,
                    const float* __restrict__ w, const int* __restrict__ com_v,
                    const float* __restrict__ volcom_v,
                    const int* __restrict__ sizecom_v,
                    const float* __restrict__ deg_v,
                    const float* __restrict__ inv_vol_ptr, int singleton_rule,
                    int sentinel, long long n_rows, int* __restrict__ out_best,
                    unsigned char* __restrict__ out_prop) {
  const long long first = static_cast<long long>(blockIdx.x) * kWarpBlockRows +
                          (threadIdx.x / 32) * kWarpRows;
  repro_torch::louvain_rows_by_warp<K, W, kWarpRows>(
      Resident{rows, nbr, w, DeviceTable<int>{com_v},
               DeviceTable<float>{volcom_v}, DeviceTable<int>{sizecom_v},
               DeviceTable<float>{deg_v}, sentinel},
      *inv_vol_ptr, singleton_rule, first, n_rows,
      LouvainProposal{out_best, out_prop});
}

template <int W>
void launch(const int* rows, const int* nbr, const float* w, const int* com_v,
            const float* volcom_v, const int* sizecom_v, const float* deg_v,
            const float* inv_vol, int singleton_rule, int sentinel,
            long long n_rows, int* out_best, unsigned char* out_prop,
            cudaStream_t stream) {
  if constexpr (by_warp(W)) {
    const auto blocks = static_cast<unsigned>(
        (n_rows + kWarpBlockRows - 1) / kWarpBlockRows);
    auto kernel = repro_torch::narrow_keys<W>(sentinel)
                      ? louvain_warp_kernel<W, uint32_t>
                      : louvain_warp_kernel<W, unsigned long long>;
    kernel<<<blocks, kLocalMoveThreads, 0, stream>>>(
        rows, nbr, w, com_v, volcom_v, sizecom_v, deg_v, inv_vol,
        singleton_rule, sentinel, n_rows, out_best, out_prop);
  } else {
    constexpr int RPB = RowGroup<W>::RPB;
    const long long blocks = (n_rows + RPB - 1) / RPB;
    louvain_kernel<W><<<static_cast<unsigned>(blocks), kLocalMoveThreads, 0,
                        stream>>>(rows, nbr, w, com_v, volcom_v, sizecom_v,
                                  deg_v, inv_vol, singleton_rule, sentinel,
                                  n_rows, out_best, out_prop);
  }
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
