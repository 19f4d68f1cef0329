#!/usr/bin/env python3
"""How fast warp-level mma.sync runs on this card: the ceiling of the kernels
that multiply on the tensor cores with it (the 3xTF32 products of
``csrc/din_attention.cu``, ``csrc/afm_attention.cu`` and
``csrc/serving_topk.cu``; the bf16 ones of ``csrc/din_common.cuh``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/probe_mma_rate.py

It builds a small kernel (with ``csrc/tf32_mma.cuh``'s ``mma_tf32``) in which
every warp issues independent mma.sync into 4 or 8 accumulators in a loop,
one block an SM of 4, 8 or 16 warps, and prints one JSON line per case: the
instruction, the warps an SM, the time and the TFLOP/s it reaches, and the
cycles per mma on a sub-partition (four an SM) at the card's maximum SM clock.
Then the card's name and power limit. It reads no data; the products are of
arbitrary bits.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
#include "tf32_mma.cuh"

template <int NACC, bool BF16>
__global__ void mma_loop(float* out, int iters) {
  float acc[NACC][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  const uint32_t b[2] = {threadIdx.x * 3u, threadIdx.x * 5u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      if constexpr (BF16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        tf32mma::mma_tf32(acc[j], a, b);
      }
    }
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_rate(int kind, int blocks, int threads, int iters, float* out, float* ms) {
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  for (int rep = 0; rep < 2; ++rep) {  // the first is a warm-up
    cudaEventRecord(start);
    if (kind == 0) mma_loop<8, false><<<blocks, threads>>>(out, iters);
    if (kind == 1) mma_loop<4, false><<<blocks, threads>>>(out, iters);
    if (kind == 2) mma_loop<8, true><<<blocks, threads>>>(out, iters);
    cudaEventRecord(end);
    cudaEventSynchronize(end);
  }
  cudaEventElapsedTime(ms, start, end);
  cudaEventDestroy(start);
  cudaEventDestroy(end);
  return cudaGetLastError();
}
"""
CASES = ((0, "mma.sync m16n8k8 tf32, 8 accumulators", 8, 2 * 16 * 8 * 8),
         (1, "mma.sync m16n8k8 tf32, 4 accumulators", 4, 2 * 16 * 8 * 8),
         (2, "mma.sync m16n8k16 bf16, 8 accumulators", 8, 2 * 16 * 8 * 16))
ITERS = 4096


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mma_rate: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "mma_rate.cu", Path(tmp) / "mma_rate.so"
        src.write_text(SOURCE)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}", "-o", str(lib_path),
                        str(src)], check=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock_hz = 1e6 * float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
        out = torch.empty(sms * 16 * 32, device="cuda")
        for kind, name, acc, flop in CASES:
            for warps in (4, 8, 16):
                ms = ctypes.c_float()
                code = lib.mma_rate(kind, sms, 32 * warps, ITERS, out.data_ptr(), ctypes.byref(ms))
                if code != 0:
                    raise RuntimeError(f"mma_rate launch failed: CUDA error {code}")
                per_sm = warps * ITERS * acc  # mma a warp issues, summed over the SM's warps
                print(json.dumps({
                    "mma": name, "warps_per_sm": warps, "ms": ms.value,
                    "tflop_s": sms * per_sm * flop / (ms.value * 1e-3) / 1e12,
                    "cycles_per_mma_per_subpartition": ms.value * 1e-3 * clock_hz / (per_sm / 4)}),
                    flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
