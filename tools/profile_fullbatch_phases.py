#!/usr/bin/env python3
"""Where the fused full-batch trainers' one launch spends its time, phase by
phase.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/profile_fullbatch_phases.py

``mf_train_kernel`` (``csrc/mf_epoch.cu``) and ``lr_compact_train_kernel``
(``csrc/lr_epoch.cu``) are one cooperative launch a call whose phases end at
grid barriers (``grid.sync()``), which a profiler that times whole kernels
cannot split. This tool builds an instrumented copy of each source, beside the
launcher's library in ``build/kernels/``: at the kernel's start and after
every grid barrier, thread 0 of block 0 records the global timer, and every
warp adds the cycles it spent in each phase before reaching the barrier (its
own work, without the wait) to that phase's sum. It runs each trainer once
for 20 epochs at ``chip_smoke.py``'s main shapes (MF: the train batch, D 64,
float32 and bfloat16; LR compact: the train batch as ``fast_fit`` feeds it) and
prints one JSON line per run: the wall microseconds of the prologue and of
the gradient and Adam phases (each a mean over the epochs, the barrier that
ends the phase included), and for each phase the warps' mean and largest busy
kilocycles (``clock64``; a warp is busy from the phase's start to its arrival
at the barrier). Then the card's name and power limit. The copy is not the
shipped library.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build  # noqa: E402

MAX_MARKS = 4096
PREAMBLE = f"""
__device__ unsigned long long prof_time[{MAX_MARKS}];
__device__ unsigned long long prof_busy[{MAX_MARKS}];
__device__ unsigned long long prof_most[{MAX_MARKS}];
__device__ __forceinline__ unsigned long long prof_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
"""
START = """
  int prof_mark = 0;
  long long prof_t0 = clock64();
  if (blockIdx.x == 0 && threadIdx.x == 0) prof_time[0] = prof_now();
"""
SYNC = """
  {
    if ((threadIdx.x & 31) == 0) {
      const unsigned long long busy = clock64() - prof_t0;
      atomicAdd(&prof_busy[prof_mark + 1], busy);
      atomicMax(&prof_most[prof_mark + 1], busy);
    }
    grid.sync();
    ++prof_mark;
    if (blockIdx.x == 0 && threadIdx.x == 0 && prof_mark < %d) prof_time[prof_mark] = prof_now();
    prof_t0 = clock64();
  }
""" % MAX_MARKS
EXTERN = """
extern "C" int prof_read(void* time, void* busy, void* most) {
  cudaMemcpyFromSymbol(time, prof_time, sizeof(prof_time));
  cudaMemcpyFromSymbol(busy, prof_busy, sizeof(prof_busy));
  cudaMemcpyFromSymbol(most, prof_most, sizeof(prof_most));
  static unsigned long long zero[%d] = {};
  cudaMemcpyToSymbol(prof_time, zero, sizeof(zero));
  cudaMemcpyToSymbol(prof_busy, zero, sizeof(zero));
  cudaMemcpyToSymbol(prof_most, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
""" % MAX_MARKS


def instrument(source: str, kernel: str) -> str:
    """The source with the marks in ``kernel``'s body (its grid barriers)."""
    text = (build.CSRC_DIR / source).read_text()
    head, sep, body = text.partition("namespace {")
    text = head + PREAMBLE + sep + body
    start = text.index(f"{kernel}(")
    open_at = text.index("cg::grid_group grid = cg::this_grid();", start)
    end_line = text.index("\n", open_at)
    text = text[:end_line + 1] + START + text[end_line + 1:]
    # the kernel's body runs to the next top-level closing brace
    body_end = text.index("\n}\n", end_line)
    body = text[end_line:body_end]
    body = re.sub(r"(if \(e \+ 1 < P\.E\) )?grid\.sync\(\);",
                  lambda m: ("if (e + 1 < P.E)" if m.group(1) else "") + SYNC, body)
    return text[:end_line] + body + text[body_end:] + EXTERN


def load(source: str, kernel: str) -> ctypes.CDLL:
    out = build.BUILD_DIR / f"prof_{Path(source).stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / source
        src.write_text(instrument(source, kernel))
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}", "-o", str(out),
                        str(src)], check=True)
    return ctypes.CDLL(str(out))


def read(lib, epochs: int, warps: int) -> dict:
    time, busy, most = (torch.zeros(MAX_MARKS, dtype=torch.int64) for _ in range(3))
    lib.prof_read.argtypes = [ctypes.c_void_p] * 3
    if lib.prof_read(time.data_ptr(), busy.data_ptr(), most.data_ptr()) != 0:
        raise RuntimeError("prof_read failed")
    marks = 1 + 2 * epochs  # the kernel's start, the prologue's barrier, two an epoch but the last
    t = time[:marks].double() / 1e3  # us
    gaps = (t[1:] - t[:-1]).tolist()
    b, m = busy[1:marks].double() / 1e3, most[1:marks].double() / 1e3  # kcycles, by phase
    return {"prologue_us": gaps[0],
            "grad_phase_us": sum(gaps[1::2]) / epochs,
            "adam_phase_us": sum(gaps[2::2]) / max(1, epochs - 1),
            "busy_kcycles_mean": {"prologue": float(b[0]) / warps,
                                  "grad": float(b[1::2].mean()) / warps,
                                  "adam": float(b[2::2].mean()) / warps},
            "busy_kcycles_max": {"prologue": float(m[0]), "grad": float(m[1::2].mean()),
                                 "adam": float(m[2::2].mean())}}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("profile_fullbatch_phases: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
    from deeplearningrecommendationsystem_tpu_torch.experiments import build_model, split_batches
    from deeplearningrecommendationsystem_tpu_torch.ops.cuda import lr_epoch as cuda_lre
    from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as cuda_mfe

    libs = {"mf": load("mf_epoch.cu", "mf_train_kernel"),
            "lr": load("lr_epoch.cu", "lr_compact_train_kernel")}
    # the launchers load their library through build.load: hand them the copies
    build._loaded["mf_epoch.cu"], build._loaded["lr_epoch.cu"] = libs["mf"], libs["lr"]
    E = 20
    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.make_dataset(tmp)
        (uid, iid), y = split_batches(PRESETS["mf"], ds, "cuda")["train"]
        lr_cfg = PRESETS["lr"]
        x, ly = split_batches(lr_cfg, ds, "cuda")["train"]
        lr_model = build_model(lr_cfg, ds).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    U, I = ds.num_users, ds.num_items
    runs = []
    for dtype in ("float32", "bfloat16"):
        pu0 = 0.1 * torch.randn((U, 64), generator=gen, device="cuda")
        pi0 = 0.1 * torch.randn((I, 64), generator=gen, device="cuda")
        runs.append((f"mf {dtype} D 64", cuda_mfe._grid(0, 64, int(dtype == "bfloat16")), "mf",
                     lambda pu0=pu0, pi0=pi0, dtype=dtype: cuda_mfe.mf_fullbatch_train(
                         uid, iid, y, pu0, pi0, E, 0.01, 1e-5, dtype)))
    a = lr_model.fused_inputs(lr_model.params(), x, ly, "compact")
    runs.append(("lr compact", cuda_lre._compact_grid(0, a[2].shape[1]), "lr",
                 lambda: cuda_lre.lr_fullbatch_train_compact(*a, E, lr_cfg.learning_rate, U, I)))
    for label, blocks, which, fn in runs:
        fn()  # warm-up, then clear the marks
        torch.cuda.synchronize()
        read(libs[which], E, blocks * 8)
        fn()
        torch.cuda.synchronize()
        print(json.dumps({"run": label, "blocks": blocks, **read(libs[which], E, blocks * 8)}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
