// local_move_plp_streamed: the PLP move of local_move_plp.cu on the streamed
// table layout — each block reads the label table only inside its window.
//
// Replaces src/repro/kernels/local_move/kernel.py
// local_move_plp_pallas_streamed (body _local_move_plp_streamed_kernel).
// Plain version: src/repro_torch/kernels/local_move/ref.py
// local_move_plp_windowed_ref.
//
// Layout: rows come in blocks of `block_rows` (graph/ell.py TableWindows);
// block b's real ids lie in [lo, lo + 2*slot), lo = win_blk[b] * slot.  On
// the TPU each grid step DMAs that window into VMEM; here one CUDA block per
// row block copies it, coalesced, from the (n+1)-entry table into dynamic
// shared memory (entries past the table's end take the sentinel, as the
// plain version's window_flat pads them), synchronises, and then scores its
// rows with the resident kernel's code (local_move_plp.cuh), reading labels
// at id - lo in shared memory.  A window may take up to the opt-in maximum
// of shared memory per block less the scoring's static arrays; a larger one
// is refused before launch (local_move_plp_streamed_smem_limit), never run
// another way.
//
// Bound on the H100: bytes, the same function and bound as the resident
// kernel.  The layout itself reads n_blocks * 2*slot * 4 bytes of windows
// instead of the table once; on locality-ordered buckets that is a fraction
// of the tile bytes.
#include "local_move_plp.cuh"

namespace {

using repro_torch::PlpGathered;
using repro_torch::PlpProposal;
using repro_torch::RowGroup;
using repro_torch::WindowTable;
using repro_torch::kLocalMoveThreads;

template <int W>
__global__ void __launch_bounds__(kLocalMoveThreads)
plp_streamed_kernel(const int* __restrict__ rows, const int* __restrict__ nbr,
                    const float* __restrict__ w,
                    const int* __restrict__ labels,
                    const int* __restrict__ win_blk, int slot,
                    long long block_rows, uint32_t seed, float scale,
                    int sentinel, long long n_rows, int* __restrict__ out_best,
                    unsigned char* __restrict__ out_prop) {
  extern __shared__ int s_win[];
  const int len = 2 * slot;
  const long long lo = static_cast<long long>(win_blk[blockIdx.x]) * slot;
  repro_torch::stage_window(s_win, labels, static_cast<long long>(sentinel) + 1,
                            lo, len, sentinel);
  __syncthreads();
  const WindowTable<int> lab{s_win, lo, len};
  const long long start = static_cast<long long>(blockIdx.x) * block_rows;
  const long long end = min(start + block_rows, n_rows);
  // the loop bounds depend on blockIdx only: every thread runs every pass
  for (long long first = start; first < end; first += RowGroup<W>::RPB) {
    repro_torch::plp_score_rows<W>(
        PlpGathered<WindowTable<int>>{rows, nbr, w, lab, sentinel}, seed,
        scale, sentinel, first, end, PlpProposal{out_best, out_prop});
    __syncthreads();  // the next pass overwrites the row staging
  }
}

// The largest dynamic shared memory a block of plp_streamed_kernel<W> can
// take on the current device: the opt-in maximum per block less the
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
      err = cudaFuncGetAttributes(&attr, plp_streamed_kernel<W>);
    const int lim = optin - static_cast<int>(attr.sharedSizeBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(plp_streamed_kernel<W>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 lim);
    if (err != cudaSuccess) return err;
    limit = lim;
  }
  *out = limit;
  return cudaSuccess;
}

template <int W>
int launch(const int* rows, const int* nbr, const float* w, const int* labels,
           const int* win_blk, int slot, long long block_rows, uint32_t seed,
           float scale, int sentinel, long long n_rows, int* out_best,
           unsigned char* out_prop, cudaStream_t stream) {
  int limit = 0;
  cudaError_t err = smem_limit<W>(&limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = 2LL * slot * static_cast<long long>(sizeof(int));
  if (slot <= 0 || block_rows <= 0 || smem > limit)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_rows + block_rows - 1) / block_rows;
  plp_streamed_kernel<W><<<static_cast<unsigned>(blocks), kLocalMoveThreads,
                           static_cast<size_t>(smem), stream>>>(
      rows, nbr, w, labels, win_blk, slot, block_rows, seed, scale, sentinel,
      n_rows, out_best, out_prop);
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

// Writes to *out_bytes the largest window, in bytes of shared memory, that
// a block of the width-`width` kernel can stage.  Returns a cudaError_t.
extern "C" int local_move_plp_streamed_smem_limit(int width, int* out_bytes) {
#define REPRO_LIMIT(WIDTH) return static_cast<int>(smem_limit<WIDTH>(out_bytes))
  REPRO_WIDTHS(REPRO_LIMIT)
#undef REPRO_LIMIT
}

// Returns the cudaError_t of the launch (0 = success).  W must be one of the
// ELL bucket widths 16, 64, 256, 1024; the table has sentinel + 1 entries;
// win_blk has ceil(n_rows / block_rows) entries, one per row block.
extern "C" int local_move_plp_streamed_launch(
    const int* rows, const int* nbr, const float* w, const int* labels,
    const int* win_blk, int slot, long long block_rows, unsigned int seed,
    float scale, int sentinel, long long n_rows, int width, int* out_best,
    unsigned char* out_prop, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(WIDTH)                                                 \
  return launch<WIDTH>(rows, nbr, w, labels, win_blk, slot, block_rows,     \
                       seed, scale, sentinel, n_rows, out_best, out_prop, s)
  REPRO_WIDTHS(REPRO_LAUNCH)
#undef REPRO_LAUNCH
}
