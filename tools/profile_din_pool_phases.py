#!/usr/bin/env python3
"""Where the DIN attention pool's kernel spends its cycles, barrier by barrier.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/profile_din_pool_phases.py [--rows 26912]

``din_pool_kernel`` (``csrc/din_attention.cu``) is two groups of warps a
block, each walking its own tiles through phases between its barriers
(``group_sync``): wait for the tile's copy, t wt + b1, the positions' scores,
the softmax, the pool, then issue the next tile's copy. This tool builds an
instrumented copy beside the launcher's library in ``build/kernels/``: after
every barrier, the first thread of each group adds the ``clock64()`` cycles
since its group's previous barrier to a counter of that barrier. It runs the
pool once at a window tile of 16 users (26,912 rows of history 10, D 64,
attention (128, 64, 1); ``chip_smoke.py``'s inputs) and prints one JSON line:
each barrier's line, the calls written between it and the barrier above it,
and its cycles per tile (a block's pass through it) and share (waits included;
the loop's first barrier closes the previous tile's pool). Then the card's
name and power limit. The copy is not the shipped library.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops import din_attention as dinatt  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_attention as cuda_dinatt  # noqa: E402

SOURCE = "din_attention.cu"
COUNTERS = 1024  # barrier ids (lines), and slots (block, group)
HELPER = f"""
__device__ unsigned long long g_phase_cycles[{COUNTERS}];
__device__ long long g_phase_last[{COUNTERS}];
__device__ unsigned long long g_phase_hits[{COUNTERS}];
// The first thread of each group adds the cycles since its group's previous
// mark to barrier id.
__device__ __forceinline__ void phase_mark(int id) {{
  if (threadIdx.x % kGroupThreads == 0) {{
    const long long now = clock64();
    const int slot = blockIdx.x * kGroups + threadIdx.x / kGroupThreads;
    const long long last = g_phase_last[slot];
    if (last != 0) {{
      atomicAdd(&g_phase_cycles[id], static_cast<unsigned long long>(now - last));
      atomicAdd(&g_phase_hits[id], 1ull);
    }}
    g_phase_last[slot] = now;
  }}
}}
"""
ENTRIES = f"""
int din_phase_read(unsigned long long* cycles, unsigned long long* hits) {{
  const size_t bytes = sizeof(unsigned long long) * {COUNTERS};
  const cudaError_t err = cudaMemcpyFromSymbol(cycles, g_phase_cycles, bytes);
  return err != cudaSuccess ? err : cudaMemcpyFromSymbol(hits, g_phase_hits, bytes);
}}
int din_phase_reset() {{
  static long long zeros[{COUNTERS}];
  cudaError_t err = cudaMemcpyToSymbol(g_phase_last, zeros, sizeof zeros);
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_hits, zeros, sizeof zeros);
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof zeros);
}}
"""


def work(lines: list, barrier: int) -> list:
    """The calls between the barrier at line ``barrier`` and the one before it."""
    found = []
    for no in range(barrier - 1, max(barrier - 30, 0), -1):
        line = lines[no - 1].strip()
        if "__syncthreads();" in line or "group_sync(grp);" in line:
            break
        found += re.findall(r"\b(stage_tile|target_term|position_scores|softmax_row|pool_rows|"
                            r"cp_async_wait_all)\(", line)
    return found[::-1]


def instrumented() -> Path:
    out_dir = build.BUILD_DIR / "din_pool_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = (build.CSRC_DIR / SOURCE).read_text().splitlines()
    for no, line in enumerate(lines, 1):
        for barrier in ("__syncthreads();", "group_sync(grp);"):
            if barrier in line and not line.strip().startswith("//"):
                lines[no - 1] = line.replace(barrier, f"{barrier} phase_mark({no});", 1)
    text = "\n".join(lines) + "\n"
    text = text.replace("struct PoolLayout {", HELPER + "struct PoolLayout {", 1)
    text = text.replace('extern "C" {\n', 'extern "C" {\n' + ENTRIES, 1)
    (out_dir / SOURCE).write_text(text)
    for header in build.CSRC_DIR.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    lib = out_dir / "din_pool_phases.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out_dir / SOURCE)], check=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=26_912)  # a window tile of 16 users
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_din_pool_phases: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(instrumented()))
    for name, types in (("din_attention_fwd", cuda_dinatt._lib().din_attention_fwd.argtypes),
                        ("din_phase_read", [ctypes.c_void_p, ctypes.c_void_p]), ("din_phase_reset", [])):
        getattr(lib, name).argtypes = types
    for name in ("din_attention_error_string", "din_attention_max_history"):
        fn, shipped_fn = getattr(lib, name), getattr(cuda_dinatt._lib(), name)
        fn.argtypes, fn.restype = shipped_fn.argtypes, shipped_fn.restype
    lib.din_attention_fwd.restype = ctypes.c_int
    shipped, cuda_dinatt._lib = cuda_dinatt._lib, (lambda: lib)
    hist, tgt, att, _, _ = cs.din_inputs(args.rows, 10, 64, cs.DIN_ATTENTION, cs.DIN_FC,
                                         torch.Generator(device="cuda").manual_seed(0))
    counts, hits = (ctypes.c_ulonglong * COUNTERS)(), (ctypes.c_ulonglong * COUNTERS)()
    src = (build.CSRC_DIR / SOURCE).read_text().splitlines()
    try:
        dinatt.din_attention_pool(hist, tgt, att)
        torch.cuda.synchronize()
        if lib.din_phase_reset() != 0:
            raise RuntimeError("din_phase_reset failed")
        dinatt.din_attention_pool(hist, tgt, att)
        torch.cuda.synchronize()
        lib.din_phase_read(counts, hits)
    finally:
        cuda_dinatt._lib = shipped
    total = sum(counts)
    phases = [{"at": f"{SOURCE}:{i}", "work": work(src, i), "kcycles_per_tile": counts[i] / hits[i] / 1e3,
               "share": counts[i] / total} for i in range(COUNTERS) if hits[i]]
    print(json.dumps({"rows": args.rows, "kcycles_per_tile": sum(p["kcycles_per_tile"] for p in phases),
                      "phases": phases}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
