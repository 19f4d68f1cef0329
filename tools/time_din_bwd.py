#!/usr/bin/env python3
"""Device time of the fused DIN head's backward (or forward), to compare two
trees.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/time_din_bwd.py [--root OTHER_CHECKOUT] [--dtype float32|bfloat16]
        [--shapes train history_64 ragged fc2048] [--pooled] [--kernels] [--part fwd]

On ``chip_smoke.py``'s inputs (``din_inputs_as``, a generator of seed 0) it
times ``ops/din_head.py::din_head_bwd`` (``din_head_fwd`` with ``--part
fwd``) of the tree at ``--root`` (this one by
default; its kernels built from its own ``csrc/``) at the DIN train batch
(87,900 rows, history 10, the preset's nets), at 16,384 rows of history 64, at
the train batch's rows at ragged widths (``DIN_RAGGED``) and at fc (2048, 2048)
on 4,096 rows, twice each (``chip_smoke.py``'s ``time_ms``: CUDA events over
back-to-back calls, inputs warm). With ``--pooled`` the backward takes the
forward's pooled rows (``din_head_fused_pooled``), as training under autograd
runs it (a tree whose forward keeps none recomputes them); with ``--part
fwd`` it times the forward that keeps them (``din_head_fused_pooled``, the
autograd forward) in place of the one that does not. With ``--kernels``
it also runs one call under ``torch.profiler`` and gives each kernel's device
microseconds. One JSON line, then the card's name and power limit. Compare
trees only within one call, in turns.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile


def kernel_us(fn) -> dict:
    """Device microseconds of each kernel of one call of ``fn`` (warm)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            out[e.key[:60]] = round(us, 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--shapes", nargs="+", default=["train", "history_64", "ragged"],
                    choices=["train", "history_64", "ragged", "fc2048"])
    ap.add_argument("--pooled", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--part", choices=["bwd", "fwd"], default="bwd")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_din_bwd: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke as cs
    from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh
    from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as cuda_dh

    shapes = {"train": (87_900, (10, 64, cs.DIN_ATTENTION, cs.DIN_FC)),
              "history_64": (16_384, (64, 64, cs.DIN_ATTENTION, cs.DIN_FC)),
              "ragged": (87_900, cs.DIN_RAGGED),
              "fc2048": (4_096, (10, 64, cs.DIN_ATTENTION, (2048, 2048, 1)))}
    out = {"root": str(args.root), "dtype": args.dtype, "part": args.part, "pooled": args.pooled}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label in args.shapes:
        B, dims = shapes[label]
        hist, tgt, _, _, g, w = cs.din_inputs_as(getattr(torch, args.dtype), B, *dims, gen)
        pooled = (cuda_dh.din_head_fused_pooled(hist, tgt, w)[1]
                  if args.pooled and args.part == "bwd" else None)

        def call():
            if args.part == "fwd":
                return (cuda_dh.din_head_fused_pooled(hist, tgt, w) if args.pooled
                        else dh.din_head_fwd(hist, tgt, w))
            return dh.din_head_bwd(hist, tgt, w, g, pooled=pooled)

        out[label] = [cs.time_ms(call) for _ in range(2)]
        if args.kernels:
            out[f"{label}_kernels_us"] = kernel_us(call)
        del hist, tgt, g, w, pooled
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
