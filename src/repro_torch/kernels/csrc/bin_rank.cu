// bin_rank: per-edge rank of the destination-community key inside its source
// community's row of the bin-key table (sort-free aggregation).
//
// Replaces src/repro/kernels/aggregation/kernel.py bin_rank_pallas (body
// _bin_rank_kernel).  Plain version: src/repro_torch/kernels/aggregation/
// ref.py bin_rank_ref.
//
//   rank[e] = #{ j < W : keys[cs[e]*W + j] != empty and keys[...] < cd[e] }
//
// Masked edges carry the sink row (cs = n), whose keys stay `empty`, so they
// rank 0.  The table passed here is keys[:-1], without the claim sink.
//
// Bound on the H100: bytes.  Each edge reads 8 bytes of (cs, cd), writes 4,
// and compares W keys of its row; the whole table is (n+1)*W*4 bytes and
// rows of one community are read by all its edges.  Design: one thread per
// edge, consecutive threads on consecutive edges (coalesced cs/cd/out);
// rows are read through the read-only path as 16-byte int4 loads (W is a
// multiple of 4 and rows start 16-byte aligned), so edges of one community
// hit L2 after the first.  The TPU kernel's VMEM-resident table copy has no
// counterpart.
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
    const int4 k = __ldg(row + q);
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
