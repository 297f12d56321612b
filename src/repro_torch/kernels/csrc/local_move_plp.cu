// local_move_plp: fused gather + PLP weighted-label-mode scoring per ELL row.
//
// Replaces src/repro/kernels/local_move/kernel.py local_move_plp_pallas
// (body _local_move_plp_kernel) in its resident-table form.  Plain version:
// src/repro_torch/kernels/local_move/ref.py local_move_plp_ref.  The row
// scoring is local_move_plp.cuh, shared with the streamed kernel and the
// two-step label_argmax kernel.
//
// Bound on the H100: bytes, at every width.  The function must read each
// row's 8*W bytes of tile and its neighbors' labels; a sort-based count of
// the compares it needs (log2 W + 2 per entry) stays below that bytes term
// (PERF.md section 6).  This kernel spends W*W compares per row instead, so
// the wide buckets run far above the bound; a per-row sort is later work.
// Design: the label table is read from device memory through L2 (the TPU
// kernel's VMEM-resident table copy has no counterpart and no budget here);
// narrow rows pack into one 256-thread block (16 rows at W = 16, 4 at
// W = 64) so a block is never mostly idle.
#include "local_move_plp.cuh"

namespace {

using repro_torch::DeviceTable;
using repro_torch::PlpGathered;
using repro_torch::PlpProposal;
using repro_torch::RowGroup;
using repro_torch::kLocalMoveThreads;

template <int W>
__global__ void __launch_bounds__(kLocalMoveThreads)
plp_kernel(const int* __restrict__ rows, const int* __restrict__ nbr,
           const float* __restrict__ w, const int* __restrict__ labels,
           uint32_t seed, float scale, int sentinel, long long n_rows,
           int* __restrict__ out_best, unsigned char* __restrict__ out_prop) {
  const long long first = static_cast<long long>(blockIdx.x) * RowGroup<W>::RPB;
  repro_torch::plp_score_rows<W>(
      PlpGathered<DeviceTable<int>>{rows, nbr, w, DeviceTable<int>{labels},
                                    sentinel},
      seed, scale, sentinel, first, n_rows, PlpProposal{out_best, out_prop});
}

template <int W>
void launch(const int* rows, const int* nbr, const float* w, const int* labels,
            uint32_t seed, float scale, int sentinel, long long n_rows,
            int* out_best, unsigned char* out_prop, cudaStream_t stream) {
  constexpr int RPB = RowGroup<W>::RPB;
  const long long blocks = (n_rows + RPB - 1) / RPB;
  plp_kernel<W><<<static_cast<unsigned>(blocks), kLocalMoveThreads, 0,
                  stream>>>(rows, nbr, w, labels, seed, scale, sentinel,
                            n_rows, out_best, out_prop);
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
