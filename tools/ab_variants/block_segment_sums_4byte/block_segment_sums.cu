// block_segment_sums, A/B variant: the kernel of
// src/repro_torch/kernels/csrc/block_segment_sums.cu with its 16-byte
// cp.async staging replaced by coalesced 4-byte loads on every input.
//
// Not built by the port: kept to be timed against that kernel (PERF.md §6)
// with
//
//   python3 tools/ab_kernels.py block_segment_sums \
//       new=src/repro_torch/kernels/csrc \
//       4byte=tools/ab_variants/block_segment_sums_4byte
//
//   out[p] = sum_q vals[q] [keys[q] == keys[p]],  q in p's block of `block`
//
// The TPU kernel's (block, block) equality reduction becomes a sum along
// the run: keys are sorted, so the positions of equal keys in a block are
// one contiguous run.  Each run's total is the left fold of its values in
// ascending position order from 0.0f (__fadd_rn), so the bits are the
// same on float values as on integer ones, whatever the block size.
//
// Bound on the H100: bytes.  The function reads 8 bytes (key, value) and
// writes 4 a position, with one add a position.
//
// Design: one warp a key block, up to kWarps key blocks a CUDA block, and
// no block barrier.  The warp copies its block's keys and values into its
// own slice of shared memory with coalesced 4-byte loads, then takes the
// run heads 32 positions at a time from a ballot of keys[p] != keys[p - 1],
// one mask a 32-position row (a last row shorter than 32 is masked).  The lane of each head finds the run's end from the masks,
// folds the run serially over shared memory, eight loads ahead of the
// adds, and writes the total over the head's value; after a __syncwarp
// every position takes the total at its run's head (the highest head bit
// at or below its lane, else the last head of the rows before) and stores
// it.  The fold is serial because the bit contract fixes the order of the
// adds: a whole-block hub run is 512 dependent adds in one lane, hidden
// by the other warps in flight (a warp's slice is 4.2 KB at block 512).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;          // key blocks a CUDA block, at most
constexpr int kMaxBlock = 1024;
constexpr int kStaticSmem = 48 * 1024;

// ints of one warp's slice of shared memory: the keys, the values, then
// one head mask a 32-position row
__host__ __device__ constexpr int slice_ints(int block) {
  return 2 * block + (block + 31) / 32;
}

// The serial left fold of v[q, end) from 0.0f, eight loads ahead.
__device__ __forceinline__ float fold(const float* v, int q, int end) {
  float acc = 0.0f;
  for (; q + 8 <= end; q += 8) {
    float x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = v[q + i];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, x[i]);
  }
  for (; q < end; ++q) acc = __fadd_rn(acc, v[q]);
  return acc;
}

__global__ void __launch_bounds__(kWarps * 32)
block_segment_sums_kernel(const int* __restrict__ keys,
                          const float* __restrict__ vals, long long n_blocks,
                          int block, float* __restrict__ out) {
  extern __shared__ int s_mem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long kb =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (kb >= n_blocks) return;                    // the whole warp
  int* s_key = s_mem + warp * slice_ints(block);
  float* s_val = reinterpret_cast<float*>(s_key + block);
  unsigned* s_head = reinterpret_cast<unsigned*>(s_key + 2 * block);
  const long long base = kb * block;
  const int rows = (block + 31) >> 5;

#pragma unroll 4
  for (int p = lane; p < block; p += 32) {
    s_key[p] = __ldg(keys + base + p);
    s_val[p] = __ldg(vals + base + p);
  }
  __syncwarp();

  // bit l of row r: position 32r + l starts a run
  for (int r = 0; r < rows; ++r) {
    const int p = 32 * r + lane;
    const unsigned h = __ballot_sync(
        0xffffffffu, p < block && (p == 0 || s_key[p] != s_key[p - 1]));
    if (lane == 0) s_head[r] = h;
  }
  __syncwarp();
  // the rows that hold a head, for the runs that end in a later row
  const unsigned nz =
      __ballot_sync(0xffffffffu, lane < rows && s_head[lane] != 0u);

  const unsigned le = (2u << lane) - 1u;         // lanes at or below mine
  for (int r = 0; r < rows; ++r) {
    const unsigned h = s_head[r];
    if (!((h >> lane) & 1u)) continue;
    const unsigned later = h & ~le;
    int end = block;
    if (later) {
      end = 32 * r + __ffs(later) - 1;
    } else if (const unsigned rest = nz & ~((2u << r) - 1u)) {
      const int r2 = __ffs(rest) - 1;
      end = 32 * r2 + __ffs(s_head[r2]) - 1;
    }
    const int s = 32 * r + lane;
    s_val[s] = fold(s_val, s, end);              // only this lane reads it
  }
  __syncwarp();

  int carry = 0;                 // the last head of the rows before
  for (int r = 0; r < rows; ++r) {
    const unsigned h = s_head[r];
    const unsigned mine = h & le;
    const int p = 32 * r + lane;
    if (p < block)
      out[base + p] = s_val[mine ? 32 * r + 31 - __clz(mine) : carry];
    if (h) carry = 32 * r + 31 - __clz(h);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  n is a multiple of
// `block`, 1 <= block <= 1024; keys ascend (runs of equal keys contiguous).
extern "C" int block_segment_sums_launch(const int* keys, const float* vals,
                                         long long n, int block, float* out,
                                         void* stream) {
  if (block < 1 || block > kMaxBlock || n % block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long n_blocks = n / block;
  const size_t slice = slice_ints(block) * sizeof(int);
  // key blocks a CUDA block: kWarps, or as many slices as 48 KB holds
  const int warps = static_cast<int>(
      slice * kWarps <= kStaticSmem ? kWarps : kStaticSmem / slice);
  const long long grid = (n_blocks + warps - 1) / warps;
  block_segment_sums_kernel<<<static_cast<unsigned>(grid), 32 * warps,
                              warps * slice,
                              static_cast<cudaStream_t>(stream)>>>(
      keys, vals, n_blocks, block, out);
  return static_cast<int>(cudaGetLastError());
}
