// bin_rank, A/B variant: the kernel of csrc/bin_rank.cu with its row
// loads replaced by values made from their addresses.  Its outputs are
// wrong: it is timed only, to split the kernel's time into the row loads
// and the rest.
//
// Not built by the port: kept to be timed against the kernel in
// src/repro_torch/kernels/csrc/bin_rank.cu (PERF.md §6) with
//
//   python3 tools/ab_kernels.py bin_rank new=src/repro_torch/kernels/csrc \
//       norows=tools/ab_variants/bin_rank_norows --unchecked=norows
//
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
bin_rank_kernel(const int* __restrict__ keys, const int* __restrict__ cs,
                const int* __restrict__ cd, long long n_edges, int width,
                int empty, int* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  const int4* row = reinterpret_cast<const int4*>(
      keys + static_cast<long long>(cs[e]) * width);
  const int key = cd[e];
  int rank = 0;
  for (int q = 0; q < width / 4; ++q) {
    const int v = static_cast<int>(reinterpret_cast<unsigned long long>(row + q));
    const int4 k = make_int4(v, v + 1, v + 2, v + 3);
    rank += (k.x != empty && k.x < key) + (k.y != empty && k.y < key) +
            (k.z != empty && k.z < key) + (k.w != empty && k.w < key);
  }
  out[e] = rank;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  `width` must be a
// positive multiple of 4 and `keys` 16-byte aligned.
extern "C" int bin_rank_launch(const int* keys, const int* cs, const int* cd,
                               long long n_edges, int width, int empty,
                               int* out, void* stream) {
  if (n_edges == 0) return 0;
  if (width <= 0 || width % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (n_edges + threads - 1) / threads;
  bin_rank_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(keys, cs, cd, n_edges,
                                                         width, empty, out);
  return static_cast<int>(cudaGetLastError());
}
