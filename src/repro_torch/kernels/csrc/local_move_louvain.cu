// local_move_louvain: fused gather + Louvain Eq. 1 delta-Q argmax per ELL row.
//
// Replaces src/repro/kernels/local_move/kernel.py local_move_louvain_pallas
// (body _local_move_louvain_kernel) in its resident-table form.  Plain
// version: src/repro_torch/kernels/local_move/ref.py
// local_move_louvain_tables_ref.  The row scoring is local_move_louvain.cuh,
// shared with the streamed kernel and the two-step delta_q kernel.
//
// Bound on the H100: bytes, at every width.  The function must read each
// row's 8*W bytes of tile and four gathered table entries per neighbor; a
// sort-based count of the compares it needs stays below that bytes term
// (PERF.md section 6).  This kernel spends W*W compares per row instead.
// Design: the four tables are read from device memory through L2 (no
// counterpart of the TPU's VMEM-resident copies); narrow rows pack into one
// 256-thread block.
#include "local_move_louvain.cuh"

namespace {

using repro_torch::DeviceTable;
using repro_torch::LouvainGathered;
using repro_torch::LouvainProposal;
using repro_torch::RowGroup;
using repro_torch::kLocalMoveThreads;

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
      LouvainGathered<DeviceTable<int>, DeviceTable<float>>{
          rows, nbr, w, DeviceTable<int>{com_v}, DeviceTable<float>{volcom_v},
          DeviceTable<int>{sizecom_v}, DeviceTable<float>{deg_v}, sentinel},
      *inv_vol_ptr, singleton_rule, sentinel, first, n_rows,
      LouvainProposal{out_best, out_prop});
}

template <int W>
void launch(const int* rows, const int* nbr, const float* w, const int* com_v,
            const float* volcom_v, const int* sizecom_v, const float* deg_v,
            const float* inv_vol, int singleton_rule, int sentinel,
            long long n_rows, int* out_best, unsigned char* out_prop,
            cudaStream_t stream) {
  constexpr int RPB = RowGroup<W>::RPB;
  const long long blocks = (n_rows + RPB - 1) / RPB;
  louvain_kernel<W><<<static_cast<unsigned>(blocks), kLocalMoveThreads, 0,
                      stream>>>(rows, nbr, w, com_v, volcom_v, sizecom_v,
                                deg_v, inv_vol, singleton_rule, sentinel,
                                n_rows, out_best, out_prop);
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
