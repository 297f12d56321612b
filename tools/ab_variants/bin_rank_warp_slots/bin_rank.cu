// bin_rank, A/B variant: the warp-grouped design with every
// group's row staged once in shared memory, each lane scanning its
// group's slot.
//
// Not built by the port: kept to be timed against the kernel in
// src/repro_torch/kernels/csrc/bin_rank.cu (PERF.md §6) with
//
//   python3 tools/ab_kernels.py bin_rank new=src/repro_torch/kernels/csrc \
//       warp_slots=tools/ab_variants/bin_rank_warp_slots
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
// cs = new_com[src]).  The warp copies each group's row once, coalesced,
// into a slot of its own shared memory (16-byte cp.async copies; slots
// 16 bytes apart in bank order, so one column of several slots is read
// without conflicts), then every lane ranks its own edge against its
// group's slot (16-byte reads, broadcast within a group), all groups at
// once.  Up to kSlotInts ints of slots a warp: more groups than slots are
// ranked in turns; a row wider than the slots is read by each lane straight
// from the table.  The grid is one wave of resident warps at most; a warp
// takes every (grid's warps)-th group of 32 edges.
//
// A first version ranked a group's edges one after another with a warp
// reduction each (the row in registers, lane j holding keys j, j + 32,
// ...); that chain of 32 dependent reductions a warp made it 2.6x slower
// than one thread an edge (PERF.md §6).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kSlotInts = 1280;    // a warp's row slots: 5 KB
constexpr bool kGroupByMatch = true;

// ints from one slot to the next: the row and 16 bytes
__host__ __device__ constexpr int slot_stride(int width) { return width + 4; }

// rows a warp stages at a time; 0 for a row wider than the slots
__host__ __device__ constexpr int slots_of(int width) {
  return slot_stride(width) > kSlotInts ? 0
         : kSlotInts / slot_stride(width) < 32
             ? kSlotInts / slot_stride(width)
             : 32;
}

__host__ __device__ constexpr int warp_ints(int width) {
  return 32 + slots_of(width) * slot_stride(width);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ int count_below(int4 k, int d, int empty) {
  return (k.x != empty && k.x < d) + (k.y != empty && k.y < d) +
         (k.z != empty && k.z < d) + (k.w != empty && k.w < d);
}

__global__ void __launch_bounds__(kWarps * 32)
bin_rank_kernel(const int* __restrict__ keys, const int* __restrict__ cs,
                const int* __restrict__ cd, long long n_edges, int width,
                int empty, int* __restrict__ out) {
  extern __shared__ __align__(16) int s_mem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = slot_stride(width), slots = slots_of(width);
  const int q4 = width >> 2;
  int* s_row_of = s_mem + warp * warp_ints(width);    // a group's row
  int* s_slot = s_row_of + 32;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long t = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                     warp;
       32 * t < n_edges; t += n_warps) {
    const long long e = 32 * t + lane;
    const bool live = e < n_edges;
    const int row = live ? __ldg(cs + e) : -1;   // rows are >= 0
    const int key = live ? __ldg(cd + e) : 0;
    int leader;
    if (kGroupByMatch) {
      leader = __ffs(__match_any_sync(0xffffffffu, row)) - 1;
    } else {          // runs of equal rows: the run's first lane leads
      const int prev = __shfl_up_sync(0xffffffffu, row, 1);
      const unsigned heads =
          __ballot_sync(0xffffffffu, lane == 0 || prev != row);
      leader = 31 - __clz(heads & ((2u << lane) - 1u));
    }
    const unsigned leaders = __ballot_sync(0xffffffffu, live && leader == lane);
    const int g = __popc(leaders & ((1u << leader) - 1u));   // my group
    const int groups = __popc(leaders);
    if (live && leader == lane) s_row_of[g] = row;
    __syncwarp();
    int rank = 0;
    if (slots == 0) {
      if (live) {
        const int4* r = reinterpret_cast<const int4*>(
            keys + static_cast<long long>(row) * width);
        for (int q = 0; q < q4; ++q) rank += count_below(__ldg(r + q), key, empty);
      }
    }
    for (int g0 = 0; g0 < groups && slots > 0; g0 += slots) {
      const int nb = groups - g0 < slots ? groups - g0 : slots;
      for (int p = lane; p < nb * q4; p += 32) {
        const int s = p / q4, q = p - s * q4;
        cp_async16(s_slot + s * stride + 4 * q,
                   keys + static_cast<long long>(s_row_of[g0 + s]) * width +
                       4 * q);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
      __syncwarp();
      if (live && g >= g0 && g < g0 + nb) {
        const int4* r = reinterpret_cast<const int4*>(s_slot + (g - g0) * stride);
#pragma unroll 4
        for (int q = 0; q < q4; ++q) rank += count_below(r[q], key, empty);
      }
      __syncwarp();      // before the next turn or tile overwrites the slots
    }
    if (live) out[e] = rank;
  }
}

// Resident blocks of bin_rank_kernel on the whole card at `smem` bytes a
// block, asked again only when smem changes.
cudaError_t wave_blocks(int smem, int& blocks) {
  static int cached_smem = -1, cached = 0;
  if (smem != cached_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, bin_rank_kernel, kWarps * 32, smem);
    if (err != cudaSuccess) return err;
    cached = sms * (per_sm > 0 ? per_sm : 1);
    cached_smem = smem;
  }
  blocks = cached;
  return cudaSuccess;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  `width` must be a
// positive multiple of 4, `keys` 16-byte aligned and every cs a row of
// `keys`.
extern "C" int bin_rank_launch(const int* keys, const int* cs, const int* cd,
                               long long n_edges, int width, int empty,
                               int* out, void* stream) {
  if (n_edges == 0) return 0;
  if (width <= 0 || width % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kWarps * warp_ints(width) * static_cast<int>(sizeof(int));
  int wave = 0;
  if (const cudaError_t err = wave_blocks(smem, wave)) return static_cast<int>(err);
  const long long need = (n_edges + 32 * kWarps - 1) / (32 * kWarps);
  bin_rank_kernel<<<static_cast<unsigned>(need < wave ? need : wave),
                    kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, cs, cd, n_edges, width, empty, out);
  return static_cast<int>(cudaGetLastError());
}
