#!/usr/bin/env python3
"""The card's rate for ``mma.sync`` products: TF32 m16n8k8 (the float32
flash kernel's instruction) and bf16 m16n8k16, in TFLOP/s.

    python3 tools/mma_sync_peak.py

Blocks of 8 warps (one and two a streaming multiprocessor), each warp
issuing products into 8, 4, 2 or 1 independent accumulators in a loop of
4000 steps; the second of two launches timed with CUDA events.  The
operands stay in registers, so the rate is the tensor cores' alone, with
no load or split of an operand.  Needs one CUDA card and ``nvcc``.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

template <bool TF32, int CHAINS>
__global__ void __launch_bounds__(256) products(float* out, int iters) {
  float c[CHAINS][4] = {};
  const uint32_t x = 0x3f800000u ^ (threadIdx.x << 13);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%4,%4}, {%0,%1,%2,%3};\n"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(x));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%4,%4,%4}, {%4,%4}, {%0,%1,%2,%3};\n"
            : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
            : "r"(x));
    }
  }
  float s = 0.f;
  for (int i = 0; i < CHAINS; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  if (s == 1234.5f) out[0] = s;   // keeps the products
}

template <bool TF32, int CHAINS>
float run(int blocks, int iters, float* out) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(a);
    products<TF32, CHAINS><<<blocks, 256>>>(out, iters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
  }
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return ms;
}

// Milliseconds of one launch, or -1 on a CUDA error.
extern "C" float mma_ms(int tf32, int chains, int blocks, int iters,
                        float* out) {
  float ms = -1.f;
  if (tf32) {
    switch (chains) {
      case 1: ms = run<true, 1>(blocks, iters, out); break;
      case 2: ms = run<true, 2>(blocks, iters, out); break;
      case 4: ms = run<true, 4>(blocks, iters, out); break;
      case 8: ms = run<true, 8>(blocks, iters, out); break;
    }
  } else {
    ms = run<false, 8>(blocks, iters, out);
  }
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""

ITERS = 4000
WARPS = 8


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    out_dir = ROOT / "build" / "mma_sync_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_sync_peak.cu", out_dir / "libmma.so"
    src.write_text(SOURCE)
    subprocess.run([build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_ms.restype = ctypes.c_float
    lib.mma_ms.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(1, device="cuda")
    cases = [(1, c) for c in (8, 4, 2, 1)] + [(0, 8)]
    for tf32, chains in cases:
        k = 8 if tf32 else 16
        for per_sm in (1, 2):
            blocks = sms * per_sm
            ms = lib.mma_ms(tf32, chains, blocks, ITERS, out.data_ptr())
            if ms < 0:
                sys.exit("launch failed")
            flops = 2.0 * 16 * 8 * k * chains * ITERS * WARPS * blocks
            print(f"{'tf32 m16n8k8' if tf32 else 'bf16 m16n8k16'}, "
                  f"{chains} accumulators a warp, {per_sm * WARPS} warps an "
                  f"SM: {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s",
                  flush=True)


if __name__ == "__main__":
    main()
