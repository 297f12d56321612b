// flash_attention_fwd: causal GQA attention forward with an online softmax,
// float32 inside, for float32 or bf16 tensors in and out.
//
// Replaces src/repro/kernels/flash_attention/kernel.py flash_attention_fwd
// (body _flash_fwd_kernel).  Plain version:
// src/repro_torch/kernels/flash_attention/ref.py attention_ref.
//
//   q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), Hq % Hkv == 0; query head h
//   reads KV head h / (Hq / Hkv).  Queries are scaled by 1/sqrt(D) in f32.
//   Causal masking is aligned top left (key j visible to query i iff
//   j <= i); masked scores are -1e30, keys past Sk take no part at all.
//   o = acc / max(l, 1e-30), cast to the input dtype.
//
// Design: one CUDA block of 128 threads per (b*Hq + h, 64-row query tile),
// heaviest causal tiles first.  The block stages its query tile (scaled,
// as f32, transposed) in shared memory once, then walks the key tiles of
// 64 keys in ascending order, each staged as f32 (K transposed, V as is);
// when causal, the walk stops at the diagonal (the Pallas kernel's
// n_iter).  Each thread owns a 4-row by 8-key piece of the 64 x 64 score
// tile (keys tx + 8j, so a warp reads consecutive shared-memory words) and
// the same 4 rows by D/8 columns of the output accumulator, in registers.
// Row max and row sum combine over the 8 threads of a row group with warp
// shuffles; the probabilities go through shared memory (transposed) to the
// P.V product, read back only by the warp that wrote them.  Both products
// are explicit f32 fused multiply-adds on the CUDA cores.  Staging in f32
// needs (64 * D + 65 * D + 64 * D + 64 * 65) * 4 bytes, 115 456 at
// D = 128, past the 48 KB static limit, so it is dynamic shared memory
// after cudaFuncSetAttribute(MaxDynamicSharedMemorySize); two blocks fit
// an SM's 228 KB.  The K and P tiles are padded to a stride of 65 so the
// transposed writes hit distinct banks; the query tile, staged once per
// block, is not, to keep within that budget.
//
// Bound on the H100: operations.  The two products cost 4 * Sq * Sk * D
// flops per head (half of it under the causal mask), against 2 bytes per
// element of q, k, v and o: about 1 000 flops per byte at Sq = Sk = 4096
// and D = 128 (Sq / 4 under the mask), past the card's balance of some
// 295, so the least time is the tensor cores' (989 TFLOP/s bf16).  This kernel runs on the CUDA cores in f32
// (67 TFLOP/s peak with FMA) and reads every K/V tile once per query tile
// from L2; it is the simple, exact first version, whose time stands beside
// that bound.  The tensor-core version (wgmma, TMA, warp specialisation)
// is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // 16 row groups of 4 rows x 8 threads
constexpr int kStride = 65;      // padded stride of the K and P tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Qt: D x kBQ; Kt: D x kStride; V: kBK x D; Pt: kBK x kStride
  return sizeof(float) * (D * kBQ + D * kStride + kBK * D + kBK * kStride);
}

template <int D, class T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq,
                 int group, int Sq, int Sk, int n_qt, int bh_total,
                 bool causal) {
  extern __shared__ float smem[];
  float* s_qt = smem;                       // [D][kBQ]
  float* s_kt = s_qt + D * kBQ;             // [D][kStride]
  float* s_v = s_kt + D * kStride;          // [kBK][D]
  float* s_pt = s_v + kBK * D;              // [kBK][kStride]

  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / bh_total);
  const int bh = static_cast<int>(blockIdx.x % bh_total);
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int hk = h / group;
  const int Hkv = Hq / group;
  const int q0 = qt * kBQ;
  const T* qp = q + (static_cast<long long>(bh) * Sq + q0) * D;
  const long long kv_off = (static_cast<long long>(b) * Hkv + hk) * Sk * D;
  const T* kp = k + kv_off;
  const T* vp = v + kv_off;

  const int t = threadIdx.x;
  const int ty = t >> 3;      // row group: rows ty*4 .. ty*4+3
  const int tx = t & 7;       // keys tx + 8j, output columns tx + 8jj

  const float sqrt_d = __fsqrt_rn(static_cast<float>(D));
  for (int i = t; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float x = q0 + r < Sq ? to_f32(qp[i]) : 0.0f;
    s_qt[d * kBQ + r] = __fdiv_rn(x, sqrt_d);
  }

  constexpr int kCols = D / 8;
  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int n_kt = (Sk + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, Sq) - 1;
  const int n_iter = causal ? min(n_kt, last_row / kBK + 1) : n_kt;

  for (int kt = 0; kt < n_iter; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();              // the previous tile's reads are done
    for (int i = t; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Sk;
      const long long g = static_cast<long long>(k0) * D + i;
      s_kt[d * kStride + r] = in ? to_f32(kp[g]) : 0.0f;
      s_v[i] = in ? to_f32(vp[g]) : 0.0f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_qt[d * kBQ + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bk[j] = s_kt[d * kStride + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = __fmaf_rn(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        if (kpos >= Sk)
          s[i][j] = __int_as_float(0xff800000);   // -inf: no part
        else if (causal && kpos > qpos)
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum = __fadd_rn(sum, p);
        s_pt[(tx + 8 * j) * kStride + ty * 4 + i] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      l[i] = __fmaf_rn(l[i], alpha, sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
    __syncwarp();                 // a row group's P is written by its warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_pt[kk * kStride + ty * 4 + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = s_v[kk * D + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = __fmaf_rn(p[i], vv, acc[i][c]);
      }
    }
  }

  T* op = o + (static_cast<long long>(bh) * Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= Sq) continue;
    const float inv = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      store(op + static_cast<long long>(r) * D + tx + 8 * c,
            __fdiv_rn(acc[i][c], inv));
  }
}

template <int D, class T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Sk, bool causal,
                   cudaStream_t stream) {
  // the opt-in to dynamic shared memory past 48 KB, set before every launch
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D>()));
  if (err != cudaSuccess) return err;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int bh_total = B * Hq;
  const long long blocks = static_cast<long long>(n_qt) * bh_total;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_fwd_kernel<D, T><<<static_cast<unsigned>(blocks), kThreads,
                           smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hq / Hkv, Sq, Sk,
      n_qt, bh_total, causal);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, D>, (T*)nullptr) for the head dim and
// dtype code (0 = float32, 1 = bfloat16) the caller names.
template <class F>
cudaError_t dispatch(int D, int dtype, F f) {
  auto by_dim = [&](auto* t) -> cudaError_t {
    switch (D) {
      case 16: return f(std::integral_constant<int, 16>{}, t);
      case 32: return f(std::integral_constant<int, 32>{}, t);
      case 64: return f(std::integral_constant<int, 64>{}, t);
      case 128: return f(std::integral_constant<int, 128>{}, t);
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_dim(static_cast<float*>(nullptr));
  if (dtype == 1) return by_dim(static_cast<__nv_bfloat16*>(nullptr));
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success).  All tensors are
// contiguous (B, H, S, D); dtype 0 = float32, 1 = bfloat16; D in
// {16, 32, 64, 128}; Hq a multiple of Hkv; Sq >= 1, Sk >= 0.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, int B,
                                          int Hq, int Hkv, int Sq, int Sk,
                                          int D, int dtype, int causal,
                                          void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(D, dtype, [&](auto d, auto* t) {
    using T = std::remove_pointer_t<decltype(t)>;
    return launch<decltype(d)::value, T>(q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                         causal != 0,
                                         static_cast<cudaStream_t>(stream));
  }));
}
