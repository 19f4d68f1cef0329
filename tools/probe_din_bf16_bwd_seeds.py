#!/usr/bin/env python3
"""How far the bf16 DIN head's backward lies from its plain version and from
the float64 sums, seed by seed.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/probe_din_bf16_bwd_seeds.py [--seeds 0 1 ... 39]
        [--shapes train fc2048_4096 fc2048_20000 ...] [--out build/bwd_seeds.jsonl]
        [--pooled plain] [--tensor-pool F1 F2]

For each seed and shape it draws ``chip_smoke.py``'s inputs (``din_inputs_as``
in bf16, the history, target and cotangent from a generator of that seed, the
MLPs as ``chip_smoke.py`` draws them) at the DIN train batch (87,900 rows,
history 10, D 64, attention (128, 64, 1), fc (256, 128, 1)) or at fc (2048,
2048) on 4,096 or 20,000 rows (or, ``fc<F1>_<F2>``, at fc (256, 256), (512,
128), (512, 512), (1024, 128), (1024, 1024) on 20,000 rows), keeps the rows
that ``chip_smoke.py``'s
backward check keeps (no relu input within DIN_KINK of 0) and compares three
sets of gradients (``chip_smoke.py::din_bf16_bwd_readings``):

* ``kernel``: ``din_head_bwd`` on the card (bf16 path);
* ``plain``: ``din_head_bwd_plain`` in bf16 (float32 sums, cuBLAS), the
  reference of the backward check;
* ``exact``: the backward with every sum in float64 from the same bf16
  operands (``din_head_bwd_exact``).

With ``--pooled plain`` the kernel's backward takes the plain head's pooled
rows (float32 sums, cuBLAS) in place of its forward's (tensor-core sums): a
diagnostic of how much of the distance to the plain version the pooled rows
carry. With ``--tensor-pool F1 F2`` the kernels come from a copy of
``din_head.cu`` built with ``kTensorPoolF1 = F1`` and ``kTensorPoolF2 = F2``
(the widest fc layers at which the bf16 forward that writes the pooled rows
keeps its attention unit on the tensor cores; ``4096 4096``: at every width):
the readings those constants are set from.

One JSON line per seed and shape: the rows within DIN_BF16_KINK of a kink
and the relu inputs there (``kink_distance``'s measure),
the rows off (d hist or d target past DIN_BF16_BWD_RTOL of its largest
|value|) between kernel and plain with their kink distances, the rows off the
float64 gradients of each, and how far each lies from them on those rows. The
lines go to ``--out``; the last lines of stdout are a summary per shape (with
the seeds that pass ``check_din_bf16_bwd``'s two row counts) and the card's
name and power limit. It needs a card: without one it exits
non-zero.
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

SHAPES = {"train": (87_900, (10, 64, cs.DIN_ATTENTION, cs.DIN_FC)),
          "fc2048_4096": (4_096, (10, 64, cs.DIN_ATTENTION, cs.DIN_WIDE_FC)),
          "fc2048_20000": (20_000, (10, 64, cs.DIN_ATTENTION, cs.DIN_WIDE_FC)),
          **{f"fc{f1}_{f2}": (20_000, (10, 64, cs.DIN_ATTENTION, (f1, f2, 1)))
             for f1, f2 in ((256, 256), (512, 128), (512, 512), (1024, 128), (1024, 1024))}}


def tensor_pool_build(f1: int, f2: int) -> ctypes.CDLL:
    """din_head.cu built with kTensorPoolF1 = f1 and kTensorPoolF2 = f2, bound
    as the launcher binds it."""
    src = (build.CSRC_DIR / "din_head.cu").read_text()
    for name, value in (("kTensorPoolF1", f1), ("kTensorPoolF2", f2)):
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"din_head.cu no longer defines {name}")
    out_dir = build.BUILD_DIR / "probe_din_bf16_bwd_seeds"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC_DIR.glob("*.cuh"):
        (out_dir / header.name).write_text(header.read_text())
    (out_dir / "din_head.cu").write_text(src)
    lib = out_dir / f"din_head_tensor_pool_{f1}_{f2}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out_dir / "din_head.cu")],
                   check=True)
    return cuda_dh.bind(ctypes.CDLL(str(lib)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(40)))
    ap.add_argument("--shapes", nargs="+", choices=list(SHAPES), default=list(SHAPES))
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "bwd_seeds.jsonl")
    ap.add_argument("--pooled", choices=["forward", "plain"], default="forward")
    ap.add_argument("--tensor-pool", type=int, nargs=2, metavar=("F1", "F2"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_din_bf16_bwd_seeds: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.tensor_pool is not None:
        variant = tensor_pool_build(*args.tensor_pool)
        cuda_dh._lib = lambda: variant
    args.out.parent.mkdir(parents=True, exist_ok=True)
    summary = {}
    with args.out.open("w") as out:
        for shape in args.shapes:
            B, dims = SHAPES[shape]
            lines = []
            for seed in args.seeds:
                gen = torch.Generator(device=cs.DEVICE).manual_seed(seed)
                hist, tgt, _, _, g, weights = cs.din_inputs_as(torch.bfloat16, B, *dims, gen)
                dist, near = cs.kink_distance(hist, tgt, weights, cs.DIN_BF16_KINK)
                smooth = dist > cs.DIN_KINK
                sub = (hist[smooth].contiguous(), tgt[smooth].contiguous(), weights,
                       g[smooth].contiguous())
                pooled = None
                if args.pooled == "plain":  # the plain head's pooled rows (float32 sums, cuBLAS)
                    pooled = dh._forward(*sub[:3])[3].contiguous()
                _, _, r = cs.din_bf16_bwd_readings(sub, dist[smooth], pooled)
                r.pop("off")
                near_inputs = int(near[smooth].sum())
                passes = (r["rows_off"] <= -(-cs.DIN_BF16_OFF_SHARE * near_inputs // 1)
                          and max(r["off_kink"], default=0.0) <= cs.DIN_BF16_KINK
                          and r["kernel_off_exact"] - r["plain_off_exact"] <= cs.DIN_BF16_EXACT_EXCESS)
                line = {"shape": shape, "seed": seed, "tensor_pool": args.tensor_pool,
                        "near_inputs": near_inputs, "passes": passes, **r}
                lines.append(line)
                out.write(json.dumps(line) + "\n")
                out.flush()
                del hist, tgt, g, weights, sub, dist
                torch.cuda.empty_cache()
            summary[shape] = {
                "seeds": len(lines), "tensor_pool": args.tensor_pool,
                "seeds_pass": sum(x["passes"] for x in lines),
                "rows_off": [min(x["rows_off"] for x in lines), max(x["rows_off"] for x in lines)],
                "near_kink": [min(x["near_kink"] for x in lines), max(x["near_kink"] for x in lines)],
                "near_inputs": [min(x["near_inputs"] for x in lines),
                                max(x["near_inputs"] for x in lines)],
                "off_per_near_input": max(x["rows_off"] / max(x["near_inputs"], 1) for x in lines),
                "kernel_off_exact_excess": max(x["kernel_off_exact"] - x["plain_off_exact"]
                                               for x in lines),
                "off_kink_max": max([d for x in lines for d in x["off_kink"]], default=0.0),
                "kernel_off_exact": [max(x["kernel_off_exact"] for x in lines),
                                     sum(x["kernel_off_exact"] for x in lines)],
                "plain_off_exact": [max(x["plain_off_exact"] for x in lines),
                                    sum(x["plain_off_exact"] for x in lines)],
                "seeds_kernel_farther": sum(x["kernel_gap"] > x["plain_gap"] for x in lines),
                "seeds_kernel_more_off_exact": sum(x["kernel_off_exact"] > x["plain_off_exact"]
                                                   for x in lines),
            }
            print(json.dumps({"summary": shape, **summary[shape]}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
