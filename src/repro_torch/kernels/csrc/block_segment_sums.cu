// block_segment_sums: within-block run totals over SORTED keys, the first
// pass of the sorted segment sum (the aggregation GroupBy reduce, Alg. 3).
//
// Replaces src/repro/kernels/segment_sum/kernel.py block_segment_sums_pallas
// (body _block_segsum_kernel).  Plain version:
// src/repro_torch/kernels/segment_sum/ref.py block_segment_sums_ref.  The
// cross-block spine fix-up that makes these into whole-run totals is tensor
// code in src/repro_torch/kernels/segment_sum/ops.py sorted_segment_sum, as
// in the JAX package.
//
//   out[p] = sum_q vals[q] [keys[q] == keys[p]],  q in p's block of `block`
//
// Design: one CUDA block per key block, one thread per position (block <=
// 1024).  The block stages its keys and values in shared memory and finds,
// for every position, the start of its run by an inclusive max-scan of the
// run-start positions (log2(block) steps); the last position of each run
// records the run's end at its start.  The thread at each run's start then
// adds the run's values in ascending position order, and every position
// reads that one total, so every position of a run carries the same value.
// The TPU kernel's (block, block) equality reduction becomes this sum
// along the run: keys are sorted, so the positions of equal keys in a block
// are one contiguous run.  The scan keeps a block inside a hub's run (a
// vertex of degree in the tens of thousands) at log2(block) steps per
// position rather than a walk of up to block - 1.
//
// Bound on the H100: bytes.  The function reads 8 bytes (key, value) and
// writes 4 per position; the adds are one per position.  The scan costs
// log2(block) shared-memory steps per position, the sum the run's length
// in one thread.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(1024)
block_segment_sums_kernel(const int* __restrict__ keys,
                          const float* __restrict__ vals, int block,
                          float* __restrict__ out) {
  extern __shared__ int s_mem[];
  int* s_key = s_mem;
  int* s_start = s_mem + block;
  int* s_end = s_mem + 2 * block;
  float* s_val = reinterpret_cast<float*>(s_mem + 3 * block);
  float* s_tot = s_val + block;
  const long long base = static_cast<long long>(blockIdx.x) * block;
  const int p = threadIdx.x;
  s_key[p] = __ldg(keys + base + p);
  s_val[p] = __ldg(vals + base + p);
  __syncthreads();

  const int key = s_key[p];
  const bool is_start = p == 0 || s_key[p - 1] != key;
  const bool is_end = p == block - 1 || s_key[p + 1] != key;
  // start of p's run: the largest run start at or before p
  int start = is_start ? p : 0;
  s_start[p] = start;
  __syncthreads();
  for (int off = 1; off < block; off <<= 1) {
    const int other = p >= off ? s_start[p - off] : 0;
    __syncthreads();
    start = max(start, other);
    s_start[p] = start;
    __syncthreads();
  }
  if (is_end) s_end[start] = p;
  __syncthreads();
  if (is_start) {
    const int end = s_end[p];
    float acc = 0.0f;
    for (int q = p; q <= end; ++q) acc = __fadd_rn(acc, s_val[q]);
    s_tot[p] = acc;
  }
  __syncthreads();
  out[base + p] = s_tot[start];
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  n is a multiple of
// `block`, 1 <= block <= 1024; keys ascend (runs of equal keys contiguous).
extern "C" int block_segment_sums_launch(const int* keys, const float* vals,
                                         long long n, int block, float* out,
                                         void* stream) {
  if (block < 1 || block > 1024 || n % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long blocks = n / block;
  const size_t smem = 5 * static_cast<size_t>(block) * sizeof(int);
  block_segment_sums_kernel<<<static_cast<unsigned>(blocks), block, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      keys, vals, block, out);
  return static_cast<int>(cudaGetLastError());
}
