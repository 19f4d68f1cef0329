#!/usr/bin/env python3
"""How the fused MF trainer's speed follows the registers a thread may use.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/probe_mf_registers.py

It builds three copies of ``csrc/mf_epoch.cu`` beside the launcher's library in
``build/kernels/``: as shipped, and with ``mf_train_kernel``'s launch bounds
asking for 3 and for 4 resident blocks of 256 threads an SM (so at most 80 and
64 registers a thread). For each it prints one JSON line: the registers each
instantiation uses (``-Xptxas -v``), and the device ms an epoch of
``mf_fullbatch_train`` (``chip_smoke.py``'s ``time_ms`` over calls of 20
epochs) on the MF train batch (229,350 rows) at D 64 and D 256, float32 and
bfloat16, with the grid each launch took. The copies are not the shipped
library.
"""

from __future__ import annotations

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

BOUNDS = "__launch_bounds__(kThreads) mf_train_kernel"
VARIANTS = {"shipped": None, "3 blocks an SM": "__launch_bounds__(kThreads, 3) mf_train_kernel",
            "4 blocks an SM": "__launch_bounds__(kThreads, 4) mf_train_kernel"}


def variant(name: str, bounds):
    text = (build.CSRC_DIR / "mf_epoch.cu").read_text()
    if bounds is not None:
        text = text.replace(BOUNDS, bounds)
    out = build.BUILD_DIR / f"probe_mf_{len(name)}_{name[0]}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "mf_epoch.cu"
        src.write_text(text)
        done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                               f"-I{build.CSRC_DIR}", "-o", str(out), str(src)],
                              capture_output=True, text=True, check=True)
    return ctypes.CDLL(str(out)), [int(r) for r in re.findall(r"Used (\d+) registers", done.stderr)]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_mf_registers: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
    from deeplearningrecommendationsystem_tpu_torch.experiments import split_batches
    from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as cuda_mfe

    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.make_dataset(tmp)
        (uid, iid), y = split_batches(PRESETS["mf"], ds, "cuda")["train"]
    U, I = ds.num_users, ds.num_items
    for name, bounds in VARIANTS.items():
        lib, regs = variant(name, bounds)
        build._loaded["mf_epoch.cu"] = lib  # the launcher loads its library through build.load
        cuda_mfe._lib.cache_clear()
        cuda_mfe._grid.cache_clear()
        out = {"variant": name, "registers": regs}
        gen = torch.Generator(device="cuda").manual_seed(0)
        for D, dtype in ((64, "float32"), (64, "bfloat16"), (256, "float32"), (256, "bfloat16")):
            pu0 = 0.1 * torch.randn((U, D), generator=gen, device="cuda")
            pi0 = 0.1 * torch.randn((I, D), generator=gen, device="cuda")
            ms = cs.time_ms(lambda: cuda_mfe.mf_fullbatch_train(uid, iid, y, pu0, pi0, 20, 0.01,
                                                                1e-5, dtype)) / 20
            out[f"{dtype} D {D}"] = {"ms": ms, "blocks": cuda_mfe._grid(0, D, int(dtype == "bfloat16"))}
        print(json.dumps(out), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
