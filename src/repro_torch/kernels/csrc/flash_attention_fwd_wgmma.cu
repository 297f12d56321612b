// flash_attention_fwd_wgmma: causal GQA attention forward for bf16 tensors
// on Hopper's tensor cores, the probabilities kept to float32 precision.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:85
// flash_attention_fwd (body _flash_fwd_kernel) for bf16 inputs; float32
// inputs keep csrc/flash_attention_fwd.cu.  Plain version:
// src/repro_torch/kernels/flash_attention/ref.py attention_ref.
//
//   q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), bf16, D in {16, 24, 32, 64, 128,
//   192} (every head dim of the registered configs), Hq % Hkv == 0; query
//   head h reads KV head h / (Hq / Hkv).  Scores are the f32 product
//   scaled by 1/sqrt(D) afterwards (attention_ref's order).  Causal
//   masking is aligned top left (key j visible to query i iff j <= i);
//   masked scores are -1e30, keys past Sk take no part.
//   o = acc / max(l, 1e-30), rounded to bf16 once.
//
// Bound on the H100: operations.  The two products cost 4 * Sq * Sk * D
// flops per head (half of it under the causal mask) against 2 bytes per
// element of q, k, v and o, about 1 000 flops per byte at Sq = Sk = 4096
// and D = 128, past the card's balance of some 295: the least time is the
// tensor cores' (989 TFLOP/s bf16).  The design goes to them:
//
// * Grid: one block per (b*Hq + h, 128-row query tile), heaviest causal
//   tiles first.  384 threads: warpgroups 0 and 1 consume, 64 query rows
//   each; warpgroup 2 produces, and one of its threads issues every copy.
//   setmaxnreg moves the registers: the producer drops to 40, the
//   consumers rise to 232 (the 384 x 168 a block starts with).
// * Copies: TMA.  q, k and v are mapped as 3-D (D, S, B*H) tensors, so a
//   ragged tile is zero-filled inside its own head.  Rows of 128 bytes
//   (64 bf16) are the widest the 128-byte swizzle takes, so at D = 128
//   and 192 each tile is two and three column boxes; D = 32 and 16 use the
//   64- and 32-byte swizzles, whose rows they fill.  D = 24's 48-byte rows
//   are no swizzle width: its tiles are D = 32's, 64-byte rows, and the
//   tensor map keeps the tensor's 24 columns (a 48-byte global row
//   stride, a multiple of TMA's 16), so TMA zero-fills each box's columns
//   24..31 and the Q.K^T product over 32 columns is exact.  The query
//   tile is loaded once; K and V tiles of 64 keys go through a ring of
//   kStages stages with full and empty mbarriers: 4 stages of 32 KB plus
//   32 KB of q, 160 KB, at D = 128; at D = 192 four stages would take
//   48 KB of q plus 8 x 24 KB, 241 KB, over the 227 KB a block may opt
//   into, so the ring there is 3 stages (192 KB).
// * S = Q.K^T: wgmma m64n64k16, both operands read from shared memory
//   through descriptors (K-major), f32 accumulators in registers; then
//   scaled by 1/sqrt(D) and masked only on tiles that cross the diagonal
//   or Sk's edge.
// * Online softmax in registers: the row max over a row's 4 threads by
//   shuffles, m and l in f32, l summed from the f32 probabilities (each
//   thread keeps its part of l; the 4 parts are added at the end).
// * O += P.V: the tensor cores take bf16 operands, but the contract keeps
//   P in f32.  P is split into three bf16 terms, hi = bf16(P),
//   mid = bf16(P - hi), lo = bf16(P - hi - mid), which carry its 24
//   significant bits, and each term is one wgmma with A from registers
//   (the S accumulator's fragment layout: two n8 column blocks form one
//   k16 slice) and V as the transposed (MN-major) B operand.  Two terms
//   (16 bits of P) miss the check against attention_ref: an output near 0
//   of a (1, 8, 8, 128, 128, 32) case lands past its bound of one ulp
//   plus 1e-6 (tests/test_torch_flash_attention.py emulates both).  The
//   split costs 2x the bound's tensor work (one product for S, three for
//   P.V).  D = 24 runs P.V at n32 over its zero pad columns, which are
//   never stored.
// * Each tile's P.V goes into an accumulator of its own, the small terms
//   first, and is added to O in f32 (O = O * alpha + P.V).  The tensor
//   cores truncate as they accumulate; summing every tile into O on the
//   tensor cores put 167 of layer 27's outputs of the qwen3-1.7b prefill
//   past one bf16 ulp of attention_ref (chip_smoke.py on an H100 SXM).
//   At D = 192, O (96 registers) and a whole tile's P.V (96 more) would
//   not fit the consumers' 232 beside P's three terms, so the tile's P.V
//   runs in column passes of 64 (wgmma n64), each added to O before the
//   next: every output column sees the same terms in the same order as
//   one n192 product would give it.
// * Epilogue: O / max(l, 1e-30), rounded to bf16, stored from registers;
//   rows past Sq and D = 24's pad columns are not written.
//
// Not yet: persistent blocks, ping-pong between the two consumer
// warpgroups, overlap of the softmax with the next tile's S product.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 128;             // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kThreads = 384;        // 2 consumer warpgroups + 1 producer
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kNegBig = -1e30f;

// Shared-memory geometry of a head dim: each tile row is kDP columns (D,
// or 32 at D = 24), kRowBytes of the swizzle's width, cut into kChunks
// column boxes; P.V runs in passes of kPV columns.
template <int D>
struct Geo {
  static constexpr int kDP = D == 24 ? 32 : D;         // padded row width
  static constexpr int kCols = kDP < 64 ? kDP : 64;    // columns per box
  static constexpr int kRowBytes = 2 * kCols;          // = swizzle width
  static constexpr int kChunks = kDP / kCols;
  static constexpr int kQBytes = kBQ * kDP * 2;
  static constexpr int kKVBytes = kBK * kDP * 2;       // one K or V tile
  static constexpr int kStages = kDP > 128 ? 3 : 4;    // K/V ring depth
  static constexpr int kPV = kDP > 128 ? 64 : kDP;     // P.V columns a pass
  // descriptor layout code: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout =
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr int kSmem = kQBytes + 2 * kStages * kKVBytes +
                               (2 * kStages + 1) * 8 + 1024;  // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
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

// One TMA box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
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
// are in use up to this point, so it neither reads the accumulators early
// nor reuses the A fragments' registers before the wgmma has completed.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64) += A (64 x 16, shared memory) * B (16 x 64, shared memory,
// K-major); the product is D's initial value when scale_d is 0.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 16) += A (64 x 16, registers) * B (16 x 16, shared memory,
// MN-major: the transposed operand); the product is D's initial value
// when scale_d is 0.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32) += A (64 x 16, registers) * B (16 x 32, shared memory,
// MN-major: the transposed operand); the product is D's initial value
// when scale_d is 0.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared memory,
// MN-major: the transposed operand); the product is D's initial value
// when scale_d is 0.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared memory,
// MN-major: the transposed operand); the product is D's initial value
// when scale_d is 0.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(scale_d));
}


// D (64 x N) (+)= one 16-key slice of P (the A fragment a0..a3) times N
// columns of V.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (N == 128) {
    wgmma_rs_n128(d, a0, a1, a2, a3, desc_b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a0, a1, a2, a3, desc_b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a0, a1, a2, a3, desc_b, scale_d);
  } else {
    wgmma_rs_n16(d, a0, a1, a2, a3, desc_b, scale_d);
  }
}

// Pass c of the tile's P.V (columns c * kPV .. + kPV - 1) for one term of
// P: its four 16-key slices into an accumulator that starts at 0 when
// `first`.  The tensor cores truncate as they accumulate, each add on the
// accumulator's own scale, so the caller adds the small terms first.
template <int D>
__device__ __forceinline__ void tile_pv(float (&pv)[Geo<D>::kPV / 2],
                                        const uint32_t (&p)[16],
                                        uint32_t s_v_tile, int c,
                                        bool first) {
  using G = Geo<D>;
#pragma unroll
  for (int j = 0; j < kBK / 16; ++j) {
    const uint64_t dv = make_desc(
        s_v_tile + (c * G::kPV / G::kCols) * kBK * G::kRowBytes +
            16 * j * G::kRowBytes,
        kBK * G::kRowBytes, 8 * G::kRowBytes, G::kLayout);
    wgmma_pv<G::kPV>(pv, p[4 * j], p[4 * j + 1], p[4 * j + 2], p[4 * j + 3],
                     dv, first && j == 0 ? 0 : 1);
  }
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(v.x)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(v.y)) << 16);
}

// Splits the probabilities (x, y) of two neighbouring keys into three bf16
// pairs whose sum is (x, y) to float32 precision (each difference is exact
// in float32); each pair is one 32-bit register of a wgmma A fragment, the
// lower key in the lower half.
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = __fsub_rn(x, hf.x), ry = __fsub_rn(y, hf.y);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = pack(h);
  mid = pack(m);
  lo = pack(__floats2bfloat162_rn(__fsub_rn(rx, mf.x), __fsub_rn(ry, mf.y)));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                       const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v,
                       __nv_bfloat16* __restrict__ o, int Hq, int group,
                       int Sq, int Sk, int n_qt, int bh_total, int causal) {
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  // tiles on 1024-byte boundaries, where every swizzle pattern starts
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  constexpr int kStages = G::kStages;
  const uint32_t s_k = s_q + G::kQBytes;                    // kStages tiles
  const uint32_t s_v = s_k + kStages * G::kKVBytes;         // kStages tiles
  const uint32_t bar_full = s_v + kStages * G::kKVBytes;    // kStages x 8 B
  const uint32_t bar_empty = bar_full + kStages * 8;        // kStages x 8 B
  const uint32_t bar_q = bar_empty + kStages * 8;

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / bh_total);
  const int bh = static_cast<int>(blockIdx.x % bh_total);
  const int hkv = (bh / Hq) * (Hq / group) + (bh % Hq) / group;
  const int q0 = qt * kBQ;
  const int n_kt = (Sk + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, Sq) - 1;
  const int n_iter = causal ? min(n_kt, last_row / kBK + 1) : n_kt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(bar_q, G::kQBytes);
      for (int c = 0; c < G::kChunks; ++c)
        tma_load(s_q + c * kBQ * G::kRowBytes, &tmap_q, c * G::kCols, q0, bh,
                 bar_q);
      for (int kt = 0; kt < n_iter; ++kt) {
        const int st = kt % kStages;
        mbar_wait(bar_empty + 8 * st, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * st, 2 * G::kKVBytes);
        for (int c = 0; c < G::kChunks; ++c) {
          const uint32_t off = st * G::kKVBytes + c * kBK * G::kRowBytes;
          tma_load(s_k + off, &tmap_k, c * G::kCols, kt * kBK, hkv,
                   bar_full + 8 * st);
          tma_load(s_v + off, &tmap_v, c * G::kCols, kt * kBK, hkv,
                   bar_full + 8 * st);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int wg_row0 = q0 + 64 * wg;
    // this thread's rows r0 and r0 + 8; its columns 8 j + cq, 8 j + cq + 1
    const int r0 = wg_row0 + 16 * (t / 32) + lane / 4;
    const int cq = 2 * (lane % 4);
    const float scale = __fdiv_rn(1.0f, __fsqrt_rn(static_cast<float>(D)));

    float oacc[G::kDP / 2];
#pragma unroll
    for (int i = 0; i < G::kDP / 2; ++i) oacc[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY;   // row maxima
    float l0 = 0.0f, l1 = 0.0f;             // this thread's part of the sums

    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < n_iter; ++kt) {
      const int st = kt % kStages;
      mbar_wait(bar_full + 8 * st, (kt / kStages) & 1);
      const int k0 = kt * kBK;
      // under the causal mask the last tile can lie wholly above this
      // warpgroup's rows; it still releases the stage
      if (!causal || k0 <= wg_row0 + 63) {
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G::kDP / 16; ++kk) {
          const int c = kk * 16 / G::kCols;
          const int col_bytes = (kk * 16 % G::kCols) * 2;
          const uint64_t da = make_desc(
              s_q + (c * kBQ + 64 * wg) * G::kRowBytes + col_bytes, 16,
              8 * G::kRowBytes, G::kLayout);
          const uint64_t db = make_desc(
              s_k + st * G::kKVBytes + c * kBK * G::kRowBytes + col_bytes, 16,
              8 * G::kRowBytes, G::kLayout);
          wgmma_ss_n64(s, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);

#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], scale);
        if ((causal && k0 + kBK - 1 > wg_row0) || k0 + kBK > Sk) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int key = k0 + 8 * (i / 4) + cq + (i & 1);
            const int row = r0 + ((i & 2) ? 8 : 0);
            if (key >= Sk)
              s[i] = -INFINITY;                 // no part
            else if (causal && key > row)
              s[i] = kNegBig;
          }
        }

        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i & 2)
            mx1 = fmaxf(mx1, s[i]);
          else
            mx0 = fmaxf(mx0, s[i]);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
        m0 = mn0;
        m1 = mn1;

        // P and its three bf16 terms: register i / 2 of the A fragments
        // (slice i / 8 of 16 keys) holds s[i], s[i + 1]
        uint32_t p_hi[16], p_mid[16], p_lo[16];
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const float mn = (i & 2) ? mn1 : mn0;
          const float x = expf(s[i] - mn), y = expf(s[i + 1] - mn);
          if (i & 2)
            sum1 = __fadd_rn(__fadd_rn(sum1, x), y);
          else
            sum0 = __fadd_rn(__fadd_rn(sum0, x), y);
          split3(x, y, p_hi[i / 2], p_mid[i / 2], p_lo[i / 2]);
        }
        l0 = __fadd_rn(__fmul_rn(l0, alpha0), sum0);
        l1 = __fadd_rn(__fmul_rn(l1, alpha1), sum1);

        // this tile's P.V on its own, a pass of kPV columns at a time, then
        // O = O * alpha + P.V in f32 with round-to-nearest
        const uint32_t s_v_tile = s_v + st * G::kKVBytes;
#pragma unroll
        for (int c = 0; c < G::kDP / G::kPV; ++c) {
          float pv[G::kPV / 2];
          wgmma_fence();
          tile_pv<D>(pv, p_lo, s_v_tile, c, true);
          tile_pv<D>(pv, p_mid, s_v_tile, c, false);
          tile_pv<D>(pv, p_hi, s_v_tile, c, false);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(pv);
          fence_regs(p_hi);
          fence_regs(p_mid);
          fence_regs(p_lo);
#pragma unroll
          for (int i = 0; i < G::kPV / 2; ++i) {
            float& a = oacc[c * (G::kPV / 2) + i];
            a = __fmaf_rn(a, (i & 2) ? alpha1 : alpha0, pv[i]);
          }
        }
      }
      mbar_arrive(bar_empty + 8 * st);
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, off));
      l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, off));
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* out = o + static_cast<long long>(bh) * Sq * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + cq;
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(r0) * D + col) =
            __floats2bfloat162_rn(__fdiv_rn(oacc[4 * j], d0),
                                  __fdiv_rn(oacc[4 * j + 1], d0));
      if (r0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(r0 + 8) * D + col) =
            __floats2bfloat162_rn(__fdiv_rn(oacc[4 * j + 2], d1),
                                  __fdiv_rn(oacc[4 * j + 3], d1));
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime so
// that the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (D, S, BH) bf16 tensor map whose boxes are one column box by box_rows
// rows of one head, swizzled as the wgmma descriptors read them (at
// D = 24 a box of 32 columns, the last 8 past the tensor's edge: zeros).
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int S,
              int BH, int box_rows) {
  using G = Geo<D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(G::kCols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      G::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Sk, bool causal,
                   cudaStream_t stream) {
  using G = Geo<D>;
  const auto kernel = flash_fwd_wgmma_kernel<D>;
  // setmaxnreg only moves registers the block holds: the consumers' 232
  // need the 168 per thread a block of 384 starts with.  Refuse rather
  // than launch a block whose consumers would wait for them forever.
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * kThreads <
      kProducerRegs * (kThreads - kConsumers) + kConsumerRegs * kConsumers)
    return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (err != cudaSuccess) return err;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  // with no keys, k and v are never read: their maps take q's shape
  const bool keys = Sk > 0;
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(encode, &tq, q, Sq, B * Hq, kBQ) ||
      !make_map<D>(encode, &tk, keys ? k : q, keys ? Sk : Sq,
                   keys ? B * Hkv : B * Hq, kBK) ||
      !make_map<D>(encode, &tv, keys ? v : q, keys ? Sk : Sq,
                   keys ? B * Hkv : B * Hq, kBK))
    return cudaErrorInvalidValue;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(n_qt) * B * Hq;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(blocks), kThreads, G::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hq / Hkv, Sq, Sk, n_qt,
      B * Hq, causal ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  All tensors are
// contiguous bf16 (B, H, S, D) at 16-byte aligned addresses; D in
// {16, 24, 32, 64, 128, 192}; Hq a multiple of Hkv; Sq >= 1, Sk >= 0.
extern "C" int flash_attention_fwd_wgmma_launch(const void* q, const void* k,
                                                const void* v, void* o, int B,
                                                int Hq, int Hkv, int Sq,
                                                int Sk, int D, int causal,
                                                void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool c = causal != 0;
  cudaError_t err;
  switch (D) {
    case 16: err = launch<16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s); break;
    case 24: err = launch<24>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s); break;
    case 32: err = launch<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s); break;
    case 64: err = launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s); break;
    case 128: err = launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s); break;
    case 192: err = launch<192>(q, k, v, o, B, Hq, Hkv, Sq, Sk, c, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
