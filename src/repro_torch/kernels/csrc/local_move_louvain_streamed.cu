// local_move_louvain_streamed: the Louvain move of local_move_louvain.cu on
// the streamed table layout — each block reads the four composed tables
// only inside its window.
//
// Replaces src/repro/kernels/local_move/kernel.py
// local_move_louvain_pallas_streamed (body
// _local_move_louvain_streamed_kernel).  Plain version:
// src/repro_torch/kernels/local_move/ref.py local_move_louvain_windowed_ref.
//
// Layout: as local_move_plp_streamed.cu, with four windows — com_v,
// volcom_v, sizecom_v, deg_v, each 2*slot entries of 4 bytes — staged one
// after another in dynamic shared memory (entries past a table's end take
// the sentinel for com_v and 0 for the others, as window_flat pads them).
// The rows are then scored with the resident kernel's code
// (local_move_louvain.cuh), reading every table at id - lo in shared
// memory.  A window set larger than the block's shared memory is refused
// before launch (local_move_louvain_streamed_smem_limit).
//
// Bound on the H100: bytes, the same function and bound as the resident
// kernel; the layout reads n_blocks * 2*slot * 16 bytes of windows instead
// of the four tables once.
#include "local_move_louvain.cuh"

namespace {

using repro_torch::LouvainGathered;
using repro_torch::LouvainProposal;
using repro_torch::RowGroup;
using repro_torch::WindowTable;
using repro_torch::kLocalMoveThreads;

template <int W>
__global__ void __launch_bounds__(kLocalMoveThreads)
louvain_streamed_kernel(const int* __restrict__ rows,
                        const int* __restrict__ nbr,
                        const float* __restrict__ w,
                        const int* __restrict__ com_v,
                        const float* __restrict__ volcom_v,
                        const int* __restrict__ sizecom_v,
                        const float* __restrict__ deg_v,
                        const float* __restrict__ inv_vol_ptr,
                        const int* __restrict__ win_blk, int slot,
                        long long block_rows, int singleton_rule, int sentinel,
                        long long n_rows, int* __restrict__ out_best,
                        unsigned char* __restrict__ out_prop) {
  extern __shared__ int s_win[];
  const int len = 2 * slot;
  int* s_com = s_win;
  float* s_vol = reinterpret_cast<float*>(s_win + len);
  int* s_size = s_win + 2 * len;
  float* s_deg = reinterpret_cast<float*>(s_win + 3 * len);
  const long long lo = static_cast<long long>(win_blk[blockIdx.x]) * slot;
  const long long n_tab = static_cast<long long>(sentinel) + 1;
  repro_torch::stage_window(s_com, com_v, n_tab, lo, len, sentinel);
  repro_torch::stage_window(s_vol, volcom_v, n_tab, lo, len, 0.0f);
  repro_torch::stage_window(s_size, sizecom_v, n_tab, lo, len, 0);
  repro_torch::stage_window(s_deg, deg_v, n_tab, lo, len, 0.0f);
  __syncthreads();
  const WindowTable<int> com{s_com, lo, len};
  const WindowTable<float> vol{s_vol, lo, len};
  const WindowTable<int> size{s_size, lo, len};
  const WindowTable<float> deg{s_deg, lo, len};
  const float inv_vol = *inv_vol_ptr;
  const long long start = static_cast<long long>(blockIdx.x) * block_rows;
  const long long end = min(start + block_rows, n_rows);
  // the loop bounds depend on blockIdx only: every thread runs every pass
  for (long long first = start; first < end; first += RowGroup<W>::RPB) {
    repro_torch::louvain_score_rows<W>(
        LouvainGathered<WindowTable<int>, WindowTable<float>>{
            rows, nbr, w, com, vol, size, deg, sentinel},
        inv_vol, singleton_rule, sentinel, first, end,
        LouvainProposal{out_best, out_prop});
    __syncthreads();  // the next pass overwrites the row staging
  }
}

// The largest dynamic shared memory a block of louvain_streamed_kernel<W>
// can take on the current device: the opt-in maximum per block less the
// kernel's static shared memory.  Queried once per width; the first query
// also raises the kernel's dynamic shared memory limit to it.
template <int W>
cudaError_t smem_limit(int* out) {
  static int limit = -1;
  if (limit < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr{};
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, louvain_streamed_kernel<W>);
    const int lim = optin - static_cast<int>(attr.sharedSizeBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(louvain_streamed_kernel<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 lim);
    if (err != cudaSuccess) return err;
    limit = lim;
  }
  *out = limit;
  return cudaSuccess;
}

template <int W>
int launch(const int* rows, const int* nbr, const float* w, const int* com_v,
           const float* volcom_v, const int* sizecom_v, const float* deg_v,
           const float* inv_vol, const int* win_blk, int slot,
           long long block_rows, int singleton_rule, int sentinel,
           long long n_rows, int* out_best, unsigned char* out_prop,
           cudaStream_t stream) {
  int limit = 0;
  cudaError_t err = smem_limit<W>(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = 4LL * 2 * slot * static_cast<long long>(sizeof(int));
  if (slot <= 0 || block_rows <= 0 || smem > limit)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_rows + block_rows - 1) / block_rows;
  louvain_streamed_kernel<W><<<static_cast<unsigned>(blocks),
                               kLocalMoveThreads, static_cast<size_t>(smem),
                               stream>>>(
      rows, nbr, w, com_v, volcom_v, sizecom_v, deg_v, inv_vol, win_blk, slot,
      block_rows, singleton_rule, sentinel, n_rows, out_best, out_prop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define REPRO_WIDTHS(CALL) \
  switch (width) {         \
    case 16: CALL(16);     \
    case 64: CALL(64);     \
    case 256: CALL(256);   \
    case 1024: CALL(1024); \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// Writes to *out_bytes the largest window set, in bytes of shared memory,
// that a block of the width-`width` kernel can stage.  Returns a
// cudaError_t.
extern "C" int local_move_louvain_streamed_smem_limit(int width,
                                                      int* out_bytes) {
#define REPRO_LIMIT(WIDTH) return static_cast<int>(smem_limit<WIDTH>(out_bytes))
  REPRO_WIDTHS(REPRO_LIMIT)
#undef REPRO_LIMIT
}

// Returns the cudaError_t of the launch (0 = success).  W must be one of the
// ELL bucket widths 16, 64, 256, 1024; the tables have sentinel + 1
// entries; win_blk has ceil(n_rows / block_rows) entries; `inv_vol` points
// to the float32 1/vol(V) on the device.
extern "C" int local_move_louvain_streamed_launch(
    const int* rows, const int* nbr, const float* w, const int* com_v,
    const float* volcom_v, const int* sizecom_v, const float* deg_v,
    const float* inv_vol, const int* win_blk, int slot, long long block_rows,
    int singleton_rule, int sentinel, long long n_rows, int width,
    int* out_best, unsigned char* out_prop, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(WIDTH)                                                  \
  return launch<WIDTH>(rows, nbr, w, com_v, volcom_v, sizecom_v, deg_v,      \
                       inv_vol, win_blk, slot, block_rows, singleton_rule,   \
                       sentinel, n_rows, out_best, out_prop, s)
  REPRO_WIDTHS(REPRO_LAUNCH)
#undef REPRO_LAUNCH
}
