// flash_attention_fwd: causal GQA attention forward for float32 tensors on
// Hopper's tensor cores, both products by wgmma in split TF32.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:85
// flash_attention_fwd (body _flash_fwd_kernel, pallas_call at :115) for
// float32 inputs; bf16 inputs launch csrc/flash_attention_fwd_wgmma.cu.
// Plain version: src/repro_torch/kernels/flash_attention/ref.py
// attention_ref.
//
//   q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), float32, D in {16, 24, 32, 64,
//   128, 192}, Hq % Hkv == 0; query head h reads KV head h / (Hq / Hkv).
//   Queries are scaled by 1/sqrt(D) in f32.  Causal masking is aligned
//   top left (key j visible to query i iff j <= i); masked scores are
//   -1e30, keys past Sk take no part at all.  o = acc / max(l, 1e-30).
//
// Bound on the H100: operations.  The two products cost 4 * Sq * Sk * D
// flops per head (half of it under the causal mask) against 4 bytes per
// element of q, k, v and o.  The contract (rtol = atol = 1e-5 against
// attention_ref in float32) is kept on the tensor cores by splitting each
// float32 operand x into two TF32 values, hi = rna(x) and lo = rna(x - hi)
// (rna: to nearest, ties away from zero, as cvt.rna.tf32.f32, here by two
// integer instructions where the cvt takes four), and each product a.b
// into lo.hi + hi.lo + hi.hi: the dropped lo.lo and the rounding of lo
// are each under 2^-22 of |a.b|.  So the least time is three TF32
// products at 495 TFLOP/s.  One TF32 product (hi.hi alone) lands past
// 1e-5 (tests/test_torch_flash_attention.py emulates both, tf32_recipe).
//
// * Why wgmma: mma.sync runs TF32 at 302-314 TFLOP/s on the H100
//   (tools/mma_sync_peak.py), and the same design on mma.sync (8 warps of
//   16 rows, every warp splitting its own fragments) took 2.68 ms at
//   (2, 16, 4096, 128) causal; this kernel takes 1.90 (tools/ab_kernels.py,
//   PERF.md; NVIDIA H100 80GB HBM3, 700 W).  wgmma wants both TF32
//   operands K-major, so V is stored transposed, and every operand it
//   reads from shared memory is split there once, into hi and lo tiles:
//   the price is shared memory, 2 x 64 KB a 32-key stage at D = 128.
// * Grid: one block per (b*Hq + h, kBQ-row query tile), heaviest causal
//   tiles first; the walk over kBK-key tiles stops at the diagonal (the
//   Pallas kernel's n_iter).  Up to D = 128: kBQ = 128, kBK = 32, 384
//   threads: warpgroup 0 produces, warpgroups 1 and 2 consume, 64 query
//   rows each; setmaxnreg moves the registers (producer 88, consumers
//   208).
// * Producer: loads each K and V tile from global memory (16-byte loads;
//   the next tile's while the ring is full), splits it into hi and lo,
//   stores K K-major and V transposed (V^T: D rows of kBK keys), both in
//   the swizzled layouts wgmma reads, into a ring of two stages with full
//   and empty mbarriers.  A k or v that is not 16-byte aligned takes
//   4-byte loads.  Shared memory at D = 128: q lo 64 KB + 2 x 64 KB.
// * Consumers: q hi stays in registers as the A fragments of S; q lo is
//   split into a K-major tile.  S = Q.K^T per 8-column k-step: lo.hi
//   (both from shared memory), hi.lo and hi.hi (A from registers), wgmma
//   m64nKk8 (N = kBK).  Masks only on tiles that cross the warpgroup's
//   diagonal or Sk's edge.  Online softmax in registers: the row max over
//   a row's 4 threads by shuffles, m and l in f32 (each thread keeps its
//   part of l).
// * O += P.V: P's hi and lo are A fragments straight from the S
//   accumulators, because the keys of V^T are stored in the accumulator
//   layout's order (a thread holds keys 2t and 2t + 1 of each 8-key
//   block, the A fragment's k = t and t + 4).  Each tile's P.V goes into
//   an accumulator of its own, 64 columns at a time (wgmma m64n64k8 with
//   A from registers), and is added to O in f32 with round-to-nearest
//   (O = O * alpha + PV): the tensor cores truncate as they accumulate,
//   and one accumulator across a whole row of tiles would let that build
//   up.
// * D = 24: its 96-byte rows are no swizzle width, so q and K tiles keep
//   D = 32's 128-byte rows and the S product reads only their first 24
//   columns (3 k-steps; the pad is never read); V^T has 24 rows and P.V
//   runs at n24.
// * D = 192 takes another geometry.  At kBK = 32 a stage is 96 KB and q lo
//   96 KB: 288 KB, past the 227 KB a block may opt into.  A 16-key tile
//   (48 KB a stage) fits the shared memory, but not the registers: q hi
//   as A fragments (96) and O (96) leave the consumers' 208 too little for
//   S, P's hi and lo and a P.V pass, and would spill in the inner loop.
//   So at D = 192 q hi is a K-major tile in shared memory too (S is three
//   products with both operands from shared memory, in the same order),
//   one consumer warpgroup takes kBQ = 64 query rows (q hi + lo 96 KB,
//   plus 2 x 48 KB of K/V: 192 KB), and the block is 256 threads, whose
//   share of the register file needs no setmaxnreg (255 a thread).  The
//   producer splits each K/V tile for 64 query rows instead of 128.
// * Epilogue: O / max(l, 1e-30) stored from registers; rows past Sq are
//   not written.
//
// At 1.90 ms the products run at about 217 TFLOP/s, 2.3 times the 0.83
// ms bound.  Not yet: ping-pong between the two consumer warpgroups, the
// softmax overlapped with the next tile's S product, a deeper ring.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStages = 2;            // K/V ring depth
// setmaxnreg moves registers within a 384-thread block's 384 x 168:
// 128 x 88 + 256 x 208
constexpr int kProducerRegs = 88;
constexpr int kConsumerRegs = 208;
constexpr float kNegBig = -1e30f;

// Geometry of a head dim.  Q and K tiles are K-major: rows of kDP floats
// (D, or 32 at D = 24) cut into boxes of kCols floats, one swizzle row
// (kRowBytes: 128 bytes, or 64 at D = 16) each.  V is stored transposed
// (V^T: D rows of the tile's kBK keys, kVRowBytes: 128 bytes at kBK = 32,
// 64 at 16, swizzled as wide).  K and V come as hi and lo tiles, q as its
// lo tile (and at D = 192 its hi tile; elsewhere hi stays in registers).
template <int D>
struct Geo {
  // D = 192's geometry: q hi as a tile too, one consumer warpgroup of 64
  // rows, 16-key tiles (the header says why)
  static constexpr bool kWide = D > 128;
  static constexpr int kBQ = kWide ? 64 : 128;         // query rows a block
  static constexpr int kBK = kWide ? 16 : 32;          // keys a tile
  static constexpr int kConsumers = kWide ? 1 : 2;     // warpgroups
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kDP = D == 24 ? 32 : D;
  static constexpr int kCols = kDP < 32 ? kDP : 32;
  static constexpr int kRowBytes = 4 * kCols;             // 64 or 128
  // descriptor layout code: 1 = 128-byte, 2 = 64-byte swizzle
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;
  static constexpr int kVRowBytes = 4 * kBK;              // 128 or 64
  static constexpr uint64_t kVLayout = kVRowBytes == 128 ? 1 : 2;
  static constexpr int kQBytes = kBQ * kDP * 4;           // q lo (or hi)
  static constexpr int kKBytes = kBK * kDP * 4;           // k hi or k lo
  static constexpr int kVBytes = D * kBK * 4;             // v^T hi or lo
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kVBytes;
  static constexpr int kSmem = (kWide ? 2 : 1) * kQBytes +
                               kStages * kStageBytes + 2 * kStages * 8 +
                               1024;

  // byte offset of float col (a multiple of 4) of row r in a K-major tile
  // of `rows` rows
  static __device__ __forceinline__ uint32_t kmajor(int rows, int r, int col) {
    const int box = col / kCols, chunk = (col % kCols) / 4;
    const int sw = kRowBytes == 128 ? (r & 7) : ((r >> 1) & 3);
    return static_cast<uint32_t>((box * rows + r) * kRowBytes +
                                 16 * (chunk ^ sw));
  }

  // byte offset of key position p (0 .. kBK - 1) of row d in a V^T tile
  static __device__ __forceinline__ uint32_t vt_off(int d, int p) {
    const int sw = kVRowBytes == 128 ? (d & 7) : ((d >> 1) & 3);
    return static_cast<uint32_t>(d * kVRowBytes + 16 * ((p >> 2) ^ sw) +
                                 4 * (p & 3));
  }
};

// The position of key k of a tile in V^T: within each 8-key block, key
// 2t at t and key 2t + 1 at t + 4, the order in which a thread's S
// accumulators (keys 2t, 2t + 1) are the k = t, t + 4 entries of a P.V A
// fragment.
__device__ __forceinline__ int key_pos(int k) {
  return (k & ~7) | ((k & 1) << 2) | ((k & 7) >> 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite x (to nearest,
// ties away from zero): half the unit of the 13 dropped bits added to the
// magnitude, then those bits cleared.  Two integer instructions; the cvt
// compiles to four, with a NaN test.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, both TF32: hi = rna(x), lo = rna(x - hi)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t a,
                                           uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d));
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(a));
}

// Splits four floats into the hi and lo tiles at the same offset.
__device__ __forceinline__ void store_split4(uint32_t hi, uint32_t lo,
                                             float4 x) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  st_shared4(hi, h[0], h[1], h[2], h[3]);
  st_shared4(lo, l[0], l[1], l[2], l[3]);
}

// Four consecutive floats from global memory (one 16-byte load when
// aligned), or zeros when !in.
__device__ __forceinline__ float4 load4(const float* p, bool in,
                                        bool aligned) {
  if (!in) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (aligned) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Makes this thread's shared-memory stores visible to wgmma (the async
// proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle layout code.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Tells the compiler that registers an asynchronous wgmma reads or writes
// are in use up to this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 16) (+)= A (64 x 8, shared memory) * B (8 x 16, shared
// memory), both K-major TF32; the product is D's initial value when
// scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32) (+)= A (64 x 8, shared memory) * B (8 x 32, shared
// memory), both K-major TF32; the product is D's initial value when
// scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 16) (+)= A (64 x 8, registers) * B (8 x 16, shared memory,
// K-major), TF32; the product is D's initial value when scale_d is 0.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 24) (+)= A (64 x 8, registers) * B (8 x 24, shared memory,
// K-major), TF32; the product is D's initial value when scale_d is 0.
__device__ __forceinline__ void wgmma_rs_n24(float (&d)[12],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 32) (+)= A (64 x 8, registers) * B (8 x 32, shared memory,
// K-major), TF32; the product is D's initial value when scale_d is 0.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 64) (+)= A (64 x 8, registers) * B (8 x 64, shared memory,
// K-major), TF32; the product is D's initial value when scale_d is 0.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x N) (+)= A (64 x 8, registers) * B (8 x N, shared memory,
// K-major), TF32: one 8-key slice of P times N columns of V, or a k-step
// of S from q hi's fragments.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, desc_b, scale_d);
  } else if constexpr (N == 24) {
    wgmma_rs_n24(d, a, desc_b, scale_d);
  } else {
    wgmma_rs_n16(d, a, desc_b, scale_d);
  }
}

// D (64 x N) (+)= A (64 x 8) * B (8 x N), both from shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_ss_n16(d, desc_a, desc_b, scale_d);
  }
}

template <int D>
__global__ void __launch_bounds__(Geo<D>::kThreads, 1)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int Hq, int group, int Sq, int Sk, int n_qt,
                      int bh_total, bool causal, bool aligned) {
  using G = Geo<D>;
  constexpr int kBQ = G::kBQ, kBK = G::kBK;
  extern __shared__ uint8_t smem_raw[];
  // tiles on 1024-byte boundaries, where every swizzle pattern starts
  const uint32_t s_ql = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_qh = s_ql + G::kQBytes;                 // D = 192 only
  const uint32_t ring = s_ql + (G::kWide ? 2 : 1) * G::kQBytes;
  const uint32_t bar_full = ring + kStages * G::kStageBytes;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / bh_total);
  const int bh = static_cast<int>(blockIdx.x % bh_total);
  const int b = bh / Hq;
  const int hk = (bh % Hq) / group;
  const int Hkv = Hq / group;
  const int q0 = qt * kBQ;
  const int n_kt = (Sk + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, Sq) - 1;
  const int n_iter = causal ? min(n_kt, last_row / kBK + 1) : n_kt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 128);
      mbar_init(bar_empty + 8 * s, 128 * G::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: loads each K and V tile, splits it into hi and lo,
    // stores K K-major and V transposed
    if constexpr (G::kConsumers == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const long long kv_off = (static_cast<long long>(b) * Hkv + hk) * Sk * D;
    const float* kp = k + kv_off;
    const float* vp = v + kv_off;
    constexpr int kC4 = D / 4;                 // 16-byte chunks a row
    // chunks a thread: K has kBK * kC4 of them, V 4 * kBK for every 4
    // columns of chunks (at D = 24 the last group is cut at kC4); only
    // D = 24 leaves threads without a chunk (kExact false)
    constexpr int kN = (4 * kBK * ((kC4 + 3) / 4) + 127) / 128;
    constexpr bool kExact = kBK * kC4 == 128 * kN && kC4 % 4 == 0;
    // K: a warp takes whole rows.  V: a warp takes 4 chunks of 8 keys, so
    // its transposed stores spread over the banks
    float4 xk[kN], xv[kN];
    auto load_tile = [&](int k0) {
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int i = t + 128 * n;
        int r = i / kC4, c = i % kC4;
        bool in = (kExact || r < kBK) && k0 + r < Sk;
        xk[n] = load4(kp + static_cast<long long>(in ? k0 + r : 0) * D + 4 * c,
                      in, aligned);
        r = (i / 4) % kBK;
        c = 4 * (i / (4 * kBK)) + i % 4;
        in = (kExact || c < kC4) && k0 + r < Sk;
        xv[n] = load4(vp + static_cast<long long>(in ? k0 + r : 0) * D +
                          4 * (kExact || in ? c : 0),
                      in, aligned);
      }
    };
    if (n_iter > 0) load_tile(0);
    for (int kt = 0; kt < n_iter; ++kt) {
      const int st = kt % kStages;
      mbar_wait(bar_empty + 8 * st, ((kt / kStages) & 1) ^ 1);
      const uint32_t kh = ring + st * G::kStageBytes;
      const uint32_t kl = kh + G::kKBytes;
      const uint32_t vh = kl + G::kKBytes;
      const uint32_t vl = vh + G::kVBytes;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int i = t + 128 * n, r = i / kC4, c = i % kC4;
        if (!kExact && r >= kBK) continue;
        const uint32_t off = G::kmajor(kBK, r, 4 * c);
        store_split4(kh + off, kl + off, xk[n]);
      }
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const int i = t + 128 * n;
        const int r = (i / 4) % kBK, c = 4 * (i / (4 * kBK)) + i % 4;
        if (!kExact && c >= kC4) continue;
        const int p = key_pos(r);
        const float xs[4] = {xv[n].x, xv[n].y, xv[n].z, xv[n].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hi, lo;
          split(xs[e], hi, lo);
          st_shared(vh + G::vt_off(4 * c + e, p), hi);
          st_shared(vl + G::vt_off(4 * c + e, p), lo);
        }
      }
      fence_async_smem();
      mbar_arrive(bar_full + 8 * st);
      if (kt + 1 < n_iter) load_tile((kt + 1) * kBK);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 (wg - 1) .. + 63
  if constexpr (G::kConsumers == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = t / 32, lane = t % 32;
  const int wrow = 64 * (wg - 1);                // the warpgroup's first row
  const int rw = wrow + 16 * warp + lane / 4;    // rows rw and rw + 8
  const int r0 = q0 + rw;
  const int cq = 2 * (lane % 4);                 // columns 8j + cq, + 1
  const int tq = lane % 4;

  // q scaled by 1/sqrt(D): hi as this thread's A fragments of S (k-step
  // kk: rows rw, rw + 8, columns 8 kk + tq, 8 kk + tq + 4) or, at
  // D = 192, into its K-major tile; lo into its K-major tile
  constexpr int kQRegs = G::kWide ? 1 : D / 8;
  uint32_t qa[kQRegs][4];
  {
    const float* qp = q + static_cast<long long>(bh) * Sq * D;
    const float sqrt_d = __fsqrt_rn(static_cast<float>(D));
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rw + 8 * (e & 1);
        const int col = 8 * kk + tq + 4 * (e >> 1);
        const float x = q0 + r < Sq
            ? __ldg(qp + static_cast<long long>(q0 + r) * D + col) : 0.0f;
        uint32_t hi, lo;
        split(__fdiv_rn(x, sqrt_d), hi, lo);
        const uint32_t off = G::kmajor(kBQ, r, col & ~3) + 4 * (col & 3);
        if constexpr (G::kWide)
          st_shared(s_qh + off, hi);
        else
          qa[kk][e] = hi;
        st_shared(s_ql + off, lo);
      }
    fence_async_smem();
    asm volatile("bar.sync %0, 128;\n" ::"r"(wg) : "memory");
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.0f, 0.0f};
  constexpr int kPVN = D < 64 ? D : 64;          // P.V columns a pass

  for (int kt = 0; kt < n_iter; ++kt) {
    const int st = kt % kStages;
    const int k0 = kt * kBK;
    mbar_wait(bar_full + 8 * st, (kt / kStages) & 1);
    if (!causal || k0 <= q0 + wrow + 63) {
      const uint32_t kh = ring + st * G::kStageBytes;
      const uint32_t kl = kh + G::kKBytes;
      const uint32_t vh = kl + G::kKBytes;
      const uint32_t vl = vh + G::kVBytes;

      // S = Q.K^T: per 8-column k-step lo.hi (q lo from shared memory),
      // hi.lo, then hi.hi (q hi from registers, or at D = 192 from its
      // tile)
      float s[kBK / 2];
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        const int box = (kk * 8) / G::kCols;
        const int col_bytes = ((kk * 8) % G::kCols) * 4;
        const uint32_t sbo = 8 * G::kRowBytes;
        const uint32_t qa_off = (box * kBQ + wrow) * G::kRowBytes + col_bytes;
        const uint32_t kb_off = box * kBK * G::kRowBytes + col_bytes;
        wgmma_ss<kBK>(s, make_desc(s_ql + qa_off, 16, sbo, G::kLayout),
                      make_desc(kh + kb_off, 16, sbo, G::kLayout), kk > 0);
        if constexpr (G::kWide) {
          const uint64_t dq = make_desc(s_qh + qa_off, 16, sbo, G::kLayout);
          wgmma_ss<kBK>(s, dq, make_desc(kl + kb_off, 16, sbo, G::kLayout),
                        1);
          wgmma_ss<kBK>(s, dq, make_desc(kh + kb_off, 16, sbo, G::kLayout),
                        1);
        } else {
          wgmma_rs<kBK>(s, qa[kk],
                        make_desc(kl + kb_off, 16, sbo, G::kLayout), 1);
          wgmma_rs<kBK>(s, qa[kk],
                        make_desc(kh + kb_off, 16, sbo, G::kLayout), 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // masks, only where they can bite (accumulator i: row r0 + 8 * (i & 2
      // ? 1 : 0), key k0 + 8 * (i / 4) + cq + (i & 1))
      if ((causal && k0 + kBK - 1 > q0 + wrow) || k0 + kBK > Sk) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + cq + (i & 1);
          const int row = r0 + ((i & 2) ? 8 : 0);
          if (key >= Sk)
            s[i] = __int_as_float(0xff800000);   // -inf: no part
          else if (causal && key > row)
            s[i] = kNegBig;
        }
      }

      // online softmax over the row's 4 threads (half h: row r0 + 8h)
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegBig;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = expf(m[h] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            s[4 * j + e] = expf(s[4 * j + e] - m_new);
            sum = __fadd_rn(sum, s[4 * j + e]);
          }
        l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), sum);
        m[h] = m_new;
      }

      // P as TF32 A fragments: k-step j's k = t is key 8j + 2t (s[4j],
      // s[4j + 2] by row), k = t + 4 is key 8j + 2t + 1 (s[4j + 1], + 3)
      uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        split(s[4 * j], ph[j][0], pl[j][0]);
        split(s[4 * j + 2], ph[j][1], pl[j][1]);
        split(s[4 * j + 1], ph[j][2], pl[j][2]);
        split(s[4 * j + 3], ph[j][3], pl[j][3]);
      }

      // this tile's P.V on its own, kPVN columns a pass (per k-step lo.hi,
      // hi.lo, hi.hi), then O = O * alpha + P.V in f32 with
      // round-to-nearest
#pragma unroll
      for (int pass = 0; pass < D / kPVN; ++pass) {
        float pv[kPVN / 2];
        const uint32_t col0 = pass * kPVN * G::kVRowBytes;
        const uint32_t vsbo = 8 * G::kVRowBytes;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
          const uint64_t dh =
              make_desc(vh + col0 + 32 * j, 16, vsbo, G::kVLayout);
          const uint64_t dl =
              make_desc(vl + col0 + 32 * j, 16, vsbo, G::kVLayout);
          wgmma_rs<kPVN>(pv, pl[j], dh, j > 0);
          wgmma_rs<kPVN>(pv, ph[j], dl, 1);
          wgmma_rs<kPVN>(pv, ph[j], dh, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(pv);
        fence_regs(ph);
        fence_regs(pl);
#pragma unroll
        for (int i = 0; i < kPVN / 2; ++i) {
          float& a = acc[pass * (kPVN / 2) + i];
          a = __fadd_rn(__fmul_rn(a, alpha[(i >> 1) & 1]), pv[i]);
        }
      }
    }
    mbar_arrive(bar_empty + 8 * st);
  }

  // l over the row's 4 threads; O / max(l, 1e-30), rows past Sq not
  // written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 1));
    l[h] = __fadd_rn(l[h], __shfl_xor_sync(0xffffffffu, l[h], 2));
    l[h] = fmaxf(l[h], 1e-30f);
  }
  float* op = o + static_cast<long long>(bh) * Sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 x = make_float2(__fdiv_rn(acc[4 * j + 2 * h], l[h]),
                                   __fdiv_rn(acc[4 * j + 2 * h + 1], l[h]));
      *reinterpret_cast<float2*>(op + static_cast<long long>(row) * D +
                                 8 * j + cq) = x;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Sk, bool causal,
                   cudaStream_t stream) {
  using G = Geo<D>;
  const auto kernel = flash_fwd_tf32_kernel<D>;
  // setmaxnreg only moves registers the block holds: refuse rather than
  // launch a block whose consumers would wait for them forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (G::kConsumers == 2 &&
      attr.numRegs * G::kThreads < kProducerRegs * 128 + kConsumerRegs * 256)
    return cudaErrorInvalidConfiguration;
  // the opt-in to dynamic shared memory past 48 KB, set before every launch
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Sq + G::kBQ - 1) / G::kBQ;
  const int bh_total = B * Hq;
  const long long blocks = static_cast<long long>(n_qt) * bh_total;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const bool aligned = ((reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  kernel<<<static_cast<unsigned>(blocks), G::kThreads, G::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hq / Hkv, Sq,
      Sk, n_qt, bh_total, causal, aligned);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  All tensors are
// contiguous float32 (B, H, S, D); D in {16, 24, 32, 64, 128, 192}; Hq a
// multiple of Hkv; Sq >= 1, Sk >= 0.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Hq, int Hkv, int Sq, int Sk,
                                          int D, int causal, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool c = causal != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch<16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s));
    case 24: return static_cast<int>(launch<24>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s));
    case 32: return static_cast<int>(launch<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s));
    case 64: return static_cast<int>(launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s));
    case 128: return static_cast<int>(launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s));
    case 192: return static_cast<int>(launch<192>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
