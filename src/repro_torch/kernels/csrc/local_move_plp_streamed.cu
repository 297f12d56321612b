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
// row block copies it from the (n+1)-entry table into dynamic shared memory
// (entries past the table's end take the sentinel, as the plain version's
// window_flat pads them) and reads labels at id - lo there, clipped into
// the window as the plain version clips them.  A window may take up to the
// opt-in maximum of shared memory per block less the kernel's static
// arrays; a larger one is refused before launch
// (local_move_plp_streamed_smem_limit), never run another way.
//
// Bound on the H100: bytes, the same function and bound as the resident
// kernel.  Under the tile contract the function reads each row id, each
// live row's slots up to its last real one, the table entries at the
// distinct ids it gathers, and writes 5 bytes a row (chip_smoke.py's
// contract bound: 0.0061 ms on the com-dblp stand-in's W = 16 bucket);
// every slot and the whole table (316 776 x 16 x 8 bytes of tiles there)
// give the full-tile bound, 0.0133 ms (PERF.md section 6).  The layout
// itself reads n_blocks * 2*slot * 4 bytes of windows, from L2 where the
// table fits there.
//
// Design.  At W = 16, the width the main path streams (2 475 blocks of
// 128 rows on com-dblp), a row is too little work to share among threads:
// the block path (16 threads a row, staging and argmax tree in shared
// memory, about seven block barriers a pass of 16 rows) took 0.0785 ms,
// and half a warp a row with a single barrier still issued about 270 warp
// instructions for every two rows (0.0485 ms).  So at W = 16
// (plp_streamed_w16_kernel) a lane holds a whole row (common.cuh
// lane_rows, local_move_plp.cuh plp_score_lane): its 16 ids and weights
// by four 16-byte loads each, a 16 x 16 scan in registers, the argmax and
// the current label's score in the thread — 0.0277 ms (tools/
// ab_kernels.py local_move_streamed, NVIDIA H100 80GB HBM3, 700 W).  The
// block's one barrier follows the window's cp.async copy, issued with the
// first rows' loads; a thread loads its next row before it scores the
// current one (lane_rows' kPrefetch); a dead row (id = sentinel, tile
// contract) is written from its id.  Up to 128 threads a block, a row
// each at the default 128 rows a block.  The other widths keep the block path
// (plp_streamed_kernel, the resident kernel's scoring code,
// local_move_plp.cuh plp_score_rows); the main path streams none of them.
#include "local_move_plp.cuh"

namespace {

using repro_torch::PlpGathered;
using repro_torch::PlpProposal;
using repro_torch::RowGroup;
using repro_torch::WindowTable;
using repro_torch::kLocalMoveThreads;

// Threads of a W = 16 block at most: a row each at the default 128 rows a
// block (graph/ell.py stream_block_rows); smaller blocks take a warp per
// 32 rows.
constexpr int kW16Threads = 128;

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

// The W = 16 path: a lane a row (file comment).
__global__ void __launch_bounds__(kW16Threads)
plp_streamed_w16_kernel(const int* __restrict__ rows,
                        const int* __restrict__ nbr,
                        const float* __restrict__ w,
                        const int* __restrict__ labels,
                        const int* __restrict__ win_blk, int slot,
                        long long block_rows, uint32_t seed, float scale,
                        int sentinel, long long n_rows,
                        int* __restrict__ out_best,
                        unsigned char* __restrict__ out_prop) {
  extern __shared__ __align__(16) int s_win16[];
  const int len = 2 * slot;
  const int lo = win_blk[blockIdx.x] * slot;
  const long long n_tab = static_cast<long long>(sentinel) + 1;
  const WindowTable<int, int> lab{s_win16, lo, len};
  const PlpProposal out{out_best, out_prop};
  const long long start = static_cast<long long>(blockIdx.x) * block_rows;
  repro_torch::lane_rows</*kPrefetch=*/true>(
      rows, nbr, w, sentinel, start, min(start + block_rows, n_rows),
      [&] {
        repro_torch::stage_window_w16(s_win16, labels, n_tab, lo, len,
                                      sentinel);
      },
      [&](long long r) { out(r, -1, -INFINITY, 0.0f); },
      [&](long long r, int v, const int(&id)[16], const float(&wt)[16]) {
        repro_torch::plp_score_lane(lab, seed, scale, sentinel, r, v, id, wt,
                                    out);
      });
}

using Kernel = void (*)(const int*, const int*, const float*, const int*,
                        const int*, int, long long, uint32_t, float, int,
                        long long, int*, unsigned char*);

// The kernel of width W, and its threads per block.
template <int W>
Kernel kernel_of() {
  if constexpr (W == 16) return plp_streamed_w16_kernel;
  else return plp_streamed_kernel<W>;
}
template <int W>
int threads_of(long long block_rows) {
  if (W != 16) return kLocalMoveThreads;
  const long long warps = (block_rows + 31) / 32;
  return warps * 32 < kW16Threads ? static_cast<int>(warps * 32) : kW16Threads;
}

// The largest dynamic shared memory a block of kernel_of<W>() can
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
  kernel_of<W>()<<<static_cast<unsigned>(blocks), threads_of<W>(block_rows),
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
