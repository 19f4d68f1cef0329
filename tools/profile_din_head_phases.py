#!/usr/bin/env python3
"""Where the fused DIN head's kernels spend their cycles, barrier by barrier.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/profile_din_head_phases.py [--rows 87900] [--dtype bfloat16 float32]
        [--fc 256 128]

The head's kernels (``csrc/din_head.cu``, ``csrc/din_common.cuh``) are a chain
of block-wide phases between ``__syncthreads()`` calls, which a profiler that
times whole kernels cannot split. This tool builds an instrumented copy of
the two sources, beside the launcher's library in ``build/kernels/``: after
every ``__syncthreads()``, thread 0 of each block adds the ``clock64()``
cycles since the block's previous barrier to a counter of that barrier. It
then runs the forward and the backward once at the DIN train batch (D 64, L
10, attention (128, 64, 1), fc (256, 128, 1) or the widths of ``--fc``,
``chip_smoke.py``'s inputs; the
backward as training runs it, given the forward's pooled rows: the fc head's
backward (float32:
``din_head_bwd_fc_head_kernel``; bf16: ``din_head_bwd_fc_stream_kernel``), the
attention unit's (``din_head_bwd_att_kernel``), the fc weight gradients and
the slots' sum) and prints one JSON line per dtype and direction: each barrier's file
and line, the calls and loops written between it and the barrier above it,
and its cycles per tile and share (the cycles summed over the blocks, over
the tiles; a barrier's cycles are those of the phase that ends at it, waits
included). The first barrier of a loop over tiles or chunks ("the previous
tile's readers are done") closes the previous pass's last phase: the code
after the loop's last barrier. Cycles are per 16 rows in every kernel. The
float32 forward is its attention stage (``din_pool.cuh``, whose group barriers
this tool does not mark: ``tools/profile_din_pool_phases.py`` times that
kernel's phases) and ``din_head_fc_kernel``, 64 rows a block, whose phase up to
its first barrier (the staging of its rows) is not counted. The
backward's fc head kernels (up to 64 rows a tile) are marked the same way;
their loop's first barrier also closes their set-up (the columns' largest
|weight|). The streamed fc head's four products share ``stream_mm``'s
barriers (its chunk staging, the chunk's products, the epilogue and the
panel's post-pass), summed over the four. Then the card's
name and power limit. The copy is not the shipped library; it needs a card.
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
from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as cuda_dh  # noqa: E402

FILES = ("din_common.cuh", "din_head.cu")  # barrier ids: 10000 * file index + line
COUNTERS = 20000
SLOTS = 4 * 8192  # a block's last mark in each of four kernels: blocks of a launch up to 8192
HELPER = f"""
__device__ unsigned long long g_phase_cycles[{COUNTERS}];
__device__ long long g_phase_last[{SLOTS}];
// Thread 0 adds the cycles since this block's previous mark in the same kernel
// (kernel: 0 for din_common.cuh's marks and the kernels they run in, else the
// din_head.cu kernel the mark lies in) to barrier id.
__device__ __forceinline__ void phase_mark(int id, int kernel) {{
  if (threadIdx.x == 0) {{
    const long long now = clock64();
    const int slot = blockIdx.x * 4 + kernel;
    const long long last = g_phase_last[slot];
    if (last != 0) atomicAdd(&g_phase_cycles[id], static_cast<unsigned long long>(now - last));
    g_phase_last[slot] = now;
  }}
}}
"""
ENTRIES = f"""
int din_phase_read(unsigned long long* out) {{
  return cudaMemcpyFromSymbol(out, din::g_phase_cycles, sizeof(unsigned long long) * {COUNTERS});
}}
int din_phase_reset() {{
  static long long zeros[{SLOTS}];
  const cudaError_t err = cudaMemcpyToSymbol(din::g_phase_last, zeros, sizeof zeros);
  return err != cudaSuccess ? err : cudaMemcpyToSymbol(din::g_phase_cycles, zeros,
                                                        sizeof(unsigned long long) * {COUNTERS});
}}
"""


def work(lines: list, barrier: int) -> list:
    """The calls and loops between the barrier at line ``barrier`` and the one
    before it in the same file, first words of each."""
    found = []
    for no in range(barrier - 1, max(barrier - 60, 0), -1):
        line = lines[no - 1].strip()
        if "__syncthreads();" in line:
            break
        m = re.match(r"(?:din::)?(block_mm\w*<[^>]*>\(\w+|block_colsum_acc<\w+>\(\w+|store_rows\(\w+|"
                     r"row_abs\w*(?:<\w+>)?\(\w+|stream_mm<\w+>\(\w+|store_panel\(\w+|"
                     r"warp_chunk_mm|post\(|"
                     r"stage_tile|attention_forward|fc_forward|fc_weight_grad\w*|for \(\w+ \w+ = \w+)", line)
        if m:
            found.append(m.group(1))
    return found[::-1]


# din_head.cu's sections whose barriers lie in a kernel of their own, each its own
# slot of a block's last mark: from the line that opens a section to the next
# one (the backward kernel's section and din_common.cuh's marks take slot 0)
SECTIONS = (("constexpr int kFcThreads", 2),  # the float32 fc head's kernels, forward and backward
            ("// -------------------------------------------------------------", 0),
            ("constexpr int kFcChunk", 1))  # din_head_bwd_fc_kernel and its products


def kernel_slots(lines: list) -> list:
    """The slot of each line of din_head.cu: that of the section it lies in."""
    slots, slot = [], 0
    for line in lines:
        for opens, s in SECTIONS:
            if line.startswith(opens):
                slot = s
        slots.append(slot)
    return slots


def instrumented() -> Path:
    """Build the instrumented copy; returns the library's path."""
    out_dir = build.BUILD_DIR / "din_head_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC_DIR.glob("*.cuh"):  # the headers it does not mark
        if header.name not in FILES:
            (out_dir / header.name).write_text(header.read_text())
    for index, name in enumerate(FILES):
        lines = (build.CSRC_DIR / name).read_text().splitlines()
        slots = kernel_slots(lines) if name == "din_head.cu" else [0] * len(lines)
        for no, line in enumerate(lines, 1):
            if "__syncthreads();" in line and not line.strip().startswith("//"):
                mark = f"din::phase_mark({10000 * index + no}, {slots[no - 1]});"
                lines[no - 1] = line.replace("__syncthreads();", f"__syncthreads(); {mark}", 1)
        text = "\n".join(lines) + "\n"
        if name == "din_common.cuh":
            text = text.replace("namespace din {\n", "namespace din {\n" + HELPER, 1)
        else:
            text = text.replace('extern "C" {\n', 'extern "C" {\n' + ENTRIES, 1)
        (out_dir / name).write_text(text)
    lib = out_dir / "din_head_phases.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out_dir / "din_head.cu")],
                   check=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=87_900)  # the DIN train batch of chip_smoke.py
    ap.add_argument("--dtype", nargs="+", choices=["bfloat16", "float32"],
                    default=["bfloat16", "float32"])
    ap.add_argument("--fc", type=int, nargs=2, default=list(cs.DIN_FC[:2]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_din_head_phases: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    lib = cuda_dh.bind(ctypes.CDLL(str(instrumented())))
    lib.din_phase_read.argtypes = [ctypes.c_void_p]
    lib.din_phase_reset.argtypes = []
    shipped, cuda_dh._lib = cuda_dh._lib, (lambda: lib)
    src = [(build.CSRC_DIR / name).read_text().splitlines() for name in FILES]
    L, D, A, F = 10, 64, cs.DIN_ATTENTION, (*args.fc, 1)
    hist, tgt, att, fc, g = cs.din_inputs(args.rows, L, D, A, F,
                                          torch.Generator(device="cuda").manual_seed(0))
    counts = (ctypes.c_ulonglong * COUNTERS)()
    try:
        for name in args.dtype:
            dtype = getattr(torch, name)
            h, t, gg = hist.to(dtype), tgt.to(dtype), g.to(dtype)
            w = dh.din_head_weights(*([{k: v.to(dtype) for k, v in layer.items()} for layer in net]
                                      for net in (att, fc)), D)
            pooled = cuda_dh.din_head_fused_pooled(h, t, w)[1]
            for part, fn in (("forward", lambda: dh.din_head_fwd(h, t, w)),
                             ("backward", lambda: dh.din_head_bwd(h, t, w, gg, pooled=pooled))):
                fn()
                torch.cuda.synchronize()
                if lib.din_phase_reset() != 0:
                    raise RuntimeError("din_phase_reset failed")
                fn()
                torch.cuda.synchronize()
                lib.din_phase_read(counts)
                tiles = -(-args.rows // 16)  # the layout's 16-row tiles at these widths
                total = sum(counts)
                phases = [{"at": f"{FILES[i // 10000]}:{i % 10000}", "work": work(src[i // 10000], i % 10000),
                           "kcycles_per_tile": counts[i] / tiles / 1e3,
                           "share": counts[i] / total} for i in range(COUNTERS) if counts[i]]
                print(json.dumps({"dtype": name, "direction": part, "rows": args.rows, "fc": args.fc,
                                  "kcycles_per_tile": total / tiles / 1e3, "phases": phases}),
                      flush=True)
    finally:
        cuda_dh._lib = shipped
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
