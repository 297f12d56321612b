// bin_rank, A/B variant: the warp-grouped design, each row
// loaded once a group of edges that name it, an edge ranked by a warp
// reduction.
//
// Not built by the port: kept to be timed against the kernel in
// src/repro_torch/kernels/csrc/bin_rank.cu (PERF.md §6) with
//
//   python3 tools/ab_kernels.py bin_rank new=src/repro_torch/kernels/csrc \
//       warp_reduce=tools/ab_variants/bin_rank_warp_reduce
//
//   rank[e] = #{ j < W : keys[cs[e]*W + j] != empty and keys[...] < cd[e] }
//
// Masked edges carry the sink row (cs = n); the kernel ranks them against
// whatever that row holds, like any other edge.  The table passed here is
// keys[:-1], without the claim sink.
//
// Bound on the H100: bytes.  Each edge reads 8 bytes of (cs, cd) and writes
// 4; each row that the edges name is read once.  The TPU kernel's
// VMEM-resident table copy has no counterpart.
//
// Design: a warp takes 32 consecutive edges (coalesced cs, cd and out) and
// groups them by cs with __match_any_sync: the edges of one community sit
// next to each other on the main path (the coarse graphs are src-sorted and
// cs = new_com[src]).  For each group the warp loads the row once,
// coalesced, 32 keys a chunk, lane j holding keys j, j + 32, ...; then for
// each edge of the group it broadcasts cd, counts each lane's occupied
// keys below it and sums the counts over the warp (__reduce_add_sync); the
// edge's lane keeps the sum.  The next group's row is loaded before the
// current group is ranked, so a warp waits on one row load at a time, not
// one after another.  Rows wider than 32·K keys are ranked in batches of K
// chunks.  The grid is one wave of resident warps at most; a warp takes
// every (grid's warps)-th group of 32 edges.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int K>
__device__ __forceinline__ void load_chunks(int (&k)[K],
                                            const int* __restrict__ row,
                                            int j0, int width, int lane,
                                            int empty) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = j0 + 32 * i + lane;
    k[i] = j < width ? __ldg(row + j) : empty;
  }
}

// Ranks the edges of `group` against this batch of their row's keys: the
// lane of each edge adds the occupied keys below its cd to `rank`.
template <int K>
__device__ __forceinline__ void rank_group(const int (&k)[K], unsigned group,
                                           int key, int empty, int lane,
                                           int& rank) {
  while (group) {
    const int e = __ffs(group) - 1;
    group &= group - 1;
    const int d = __shfl_sync(0xffffffffu, key, e);
    int c = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) c += (k[i] != empty) & (k[i] < d);
    c = static_cast<int>(__reduce_add_sync(0xffffffffu, c));
    if (lane == e) rank += c;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
bin_rank_kernel(const int* __restrict__ keys, const int* __restrict__ cs,
                const int* __restrict__ cd, long long n_edges, int width,
                int empty, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long t = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 5;
       32 * t < n_edges; t += n_warps) {
    const long long e = 32 * t + lane;
    const bool live = e < n_edges;
    const int row = live ? __ldg(cs + e) : -1;   // rows are >= 0
    const int key = live ? __ldg(cd + e) : 0;
    const unsigned same = __match_any_sync(0xffffffffu, row);
    unsigned todo = __ballot_sync(0xffffffffu, live);
    int rank = 0;
    int lead = __ffs(todo) - 1;                  // todo holds lane 0
    int k[K];
    load_chunks(k, keys + static_cast<long long>(
                       __shfl_sync(0xffffffffu, row, lead)) * width,
                0, width, lane, empty);
    while (true) {
      const unsigned group = __shfl_sync(0xffffffffu, same, lead);
      const int* cur = keys + static_cast<long long>(
                           __shfl_sync(0xffffffffu, row, lead)) * width;
      todo &= ~group;
      const int next = __ffs(todo) - 1;          // -1: the last group
      int nk[K];
      if (next >= 0)
        load_chunks(nk, keys + static_cast<long long>(
                            __shfl_sync(0xffffffffu, row, next)) * width,
                    0, width, lane, empty);
      rank_group(k, group, key, empty, lane, rank);
      for (int j0 = 32 * K; j0 < width; j0 += 32 * K) {
        load_chunks(k, cur, j0, width, lane, empty);
        rank_group(k, group, key, empty, lane, rank);
      }
      if (next < 0) break;
#pragma unroll
      for (int i = 0; i < K; ++i) k[i] = nk[i];
      lead = next;
    }
    if (live) out[e] = rank;
  }
}

// Resident blocks of bin_rank_kernel<K> on the whole card, asked once.
template <int K>
cudaError_t wave_blocks(int& blocks) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bin_rank_kernel<K>, kThreads, 0);
    if (err != cudaSuccess) return err;
    cached = sms * (per_sm > 0 ? per_sm : 1);
  }
  blocks = cached;
  return cudaSuccess;
}

template <int K>
int launch(const int* keys, const int* cs, const int* cd, long long n_edges,
           int width, int empty, int* out, cudaStream_t stream) {
  int wave = 0;
  if (const cudaError_t err = wave_blocks<K>(wave)) return static_cast<int>(err);
  const long long need = (n_edges + kThreads - 1) / kThreads;
  const long long blocks = need < wave ? need : wave;
  bin_rank_kernel<K><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      keys, cs, cd, n_edges, width, empty, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  `width` must be a
// positive multiple of 4 and every cs a row of `keys`.
extern "C" int bin_rank_launch(const int* keys, const int* cs, const int* cd,
                               long long n_edges, int width, int empty,
                               int* out, void* stream) {
  if (n_edges == 0) return 0;
  if (width <= 0 || width % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 32) return launch<1>(keys, cs, cd, n_edges, width, empty, out, s);
  if (width <= 64) return launch<2>(keys, cs, cd, n_edges, width, empty, out, s);
  if (width <= 128) return launch<4>(keys, cs, cd, n_edges, width, empty, out, s);
  return launch<8>(keys, cs, cd, n_edges, width, empty, out, s);
}
