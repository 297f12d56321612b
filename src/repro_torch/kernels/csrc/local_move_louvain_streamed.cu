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
// the sentinel for com_v and 0 for the others, as window_flat pads them),
// every table read at id - lo there, clipped into the window.  A window set
// larger than the block's shared memory is refused before launch
// (local_move_louvain_streamed_smem_limit).
//
// Bound on the H100: bytes, the same function and bound as the resident
// kernel — the row ids, each live row's slots up to its last real one, the
// four tables' entries at the distinct ids gathered (three at the row and
// neighbour ids, deg_v at the row ids), 5 bytes out a row (chip_smoke.py's
// contract bound: 0.0072 ms on the com-dblp stand-in's W = 16 bucket); the
// full-tile bound counts every slot and every table in full, 0.0145 ms
// (PERF.md section 6).  The layout reads n_blocks * 2*slot * 16 bytes of
// windows.
//
// Design: as local_move_plp_streamed.cu.  At W = 16
// (louvain_streamed_w16_kernel) a lane holds a whole row (common.cuh
// lane_rows, local_move_louvain.cuh louvain_score_lane): S_A by the block
// path's thread-0 pass and each candidate's S_k by the scan, in registers,
// the gain and the argmax in the thread — 0.0277 ms where the block path
// (thread 0 summing S_A between two more barriers) took 0.0912 and half a
// warp a row 0.0517 (tools/ab_kernels.py local_move_streamed, NVIDIA H100
// 80GB HBM3, 700 W).  One block barrier, after the four windows' cp.async
// copy, issued with the first rows' loads; dead rows settled from their
// ids.  The other widths keep the block path (louvain_streamed_kernel,
// the resident kernel's scoring code, local_move_louvain.cuh
// louvain_score_rows).
#include "local_move_louvain.cuh"

namespace {

using repro_torch::LouvainGathered;
using repro_torch::LouvainProposal;
using repro_torch::RowGroup;
using repro_torch::WindowTable;
using repro_torch::kLocalMoveThreads;

// Threads of a W = 16 block at most: a row each at the default 128 rows a
// block (graph/ell.py stream_block_rows); smaller blocks take a warp per
// 32 rows.
constexpr int kW16Threads = 128;

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

// The W = 16 path: a lane a row (file comment).
__global__ void __launch_bounds__(kW16Threads)
louvain_streamed_w16_kernel(const int* __restrict__ rows,
                            const int* __restrict__ nbr,
                            const float* __restrict__ w,
                            const int* __restrict__ com_v,
                            const float* __restrict__ volcom_v,
                            const int* __restrict__ sizecom_v,
                            const float* __restrict__ deg_v,
                            const float* __restrict__ inv_vol_ptr,
                            const int* __restrict__ win_blk, int slot,
                            long long block_rows, int singleton_rule,
                            int sentinel, long long n_rows,
                            int* __restrict__ out_best,
                            unsigned char* __restrict__ out_prop) {
  extern __shared__ __align__(16) int s_win16[];
  const int len = 2 * slot;
  int* s_com = s_win16;
  float* s_vol = reinterpret_cast<float*>(s_win16 + len);
  int* s_size = s_win16 + 2 * len;
  float* s_deg = reinterpret_cast<float*>(s_win16 + 3 * len);
  const int lo = win_blk[blockIdx.x] * slot;
  const long long n_tab = static_cast<long long>(sentinel) + 1;
  const WindowTable<int, int> com{s_com, lo, len};
  const WindowTable<float, int> vol{s_vol, lo, len};
  const WindowTable<int, int> size{s_size, lo, len};
  const WindowTable<float, int> deg{s_deg, lo, len};
  const LouvainProposal out{out_best, out_prop};
  const long long start = static_cast<long long>(blockIdx.x) * block_rows;
  const float inv_vol = *inv_vol_ptr;
  repro_torch::lane_rows</*kPrefetch=*/false>(
      rows, nbr, w, sentinel, start, min(start + block_rows, n_rows),
      [&] {
        repro_torch::stage_window_w16(s_com, com_v, n_tab, lo, len, sentinel);
        repro_torch::stage_window_w16(s_vol, volcom_v, n_tab, lo, len, 0.0f);
        repro_torch::stage_window_w16(s_size, sizecom_v, n_tab, lo, len, 0);
        repro_torch::stage_window_w16(s_deg, deg_v, n_tab, lo, len, 0.0f);
      },
      [&](long long r) { out(r, -1, -INFINITY); },
      [&](long long r, int v, const int(&id)[16], const float(&wt)[16]) {
        repro_torch::louvain_score_lane(com, vol, size, deg, inv_vol,
                                        singleton_rule, sentinel, r, v, id, wt,
                                        out);
      });
}

using Kernel = void (*)(const int*, const int*, const float*, const int*,
                        const float*, const int*, const float*, const float*,
                        const int*, int, long long, int, int, long long, int*,
                        unsigned char*);

// The kernel of width W, and its threads per block.
template <int W>
Kernel kernel_of() {
  if constexpr (W == 16) return louvain_streamed_w16_kernel;
  else return louvain_streamed_kernel<W>;
}
template <int W>
int threads_of(long long block_rows) {
  if (W != 16) return kLocalMoveThreads;
  const long long warps = (block_rows + 31) / 32;
  return warps * 32 < kW16Threads ? static_cast<int>(warps * 32) : kW16Threads;
}

// The largest dynamic shared memory a block of kernel_of<W>() can take on
// the current device: the opt-in maximum per block less the
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
      err = cudaFuncGetAttributes(&attr, kernel_of<W>());
    const int lim = optin - static_cast<int>(attr.sharedSizeBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel_of<W>(),
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
  kernel_of<W>()<<<static_cast<unsigned>(blocks), threads_of<W>(block_rows),
                   static_cast<size_t>(smem), stream>>>(
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
