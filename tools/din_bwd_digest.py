#!/usr/bin/env python3
"""Digests of the fused DIN head backward's outputs (or, with ``--part fwd``,
its forward's logits), to hold two trees' kernels against each other bit for
bit.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/din_bwd_digest.py [--root OTHER_CHECKOUT] [--dtype bfloat16] [--part fwd]

It draws ``chip_smoke.py``'s inputs (``din_inputs_as``, a generator of seed 0)
at the DIN train batch (87,900 rows) at the preset's widths and at its ragged
widths (``DIN_RAGGED``), and on 4,096 rows at fc (2048, 2048), runs the head's
backward (``ops/din_head.py::din_head_bwd``; ``din_head_fwd``, the forward
that keeps no pooled rows, with ``--part fwd``) of the tree at
``--root`` (this one by default; its kernels built from its own ``csrc/``) and
prints one JSON line per shape: the sha256 of each of the 16 gradients' bytes
(of the logits' with ``--part fwd``). Two trees whose kernels give the same
bits print the same lines. Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    ap.add_argument("--part", choices=["bwd", "fwd"], default="bwd")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("din_bwd_digest: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke as cs
    from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh

    dtype = getattr(torch, args.dtype)
    shapes = {"preset": (87_900, (10, 64, cs.DIN_ATTENTION, cs.DIN_FC)),
              "ragged": (87_900, cs.DIN_RAGGED),
              "fc2048": (4_096, (10, 64, cs.DIN_ATTENTION, (2048, 2048, 1)))}
    for label, (B, (L, D, A, F)) in shapes.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        hist, tgt, _, _, g, weights = cs.din_inputs_as(dtype, B, L, D, A, F, gen)
        grads = (dh.din_head_bwd(hist, tgt, weights, g) if args.part == "bwd"
                 else [dh.din_head_fwd(hist, tgt, weights)])
        torch.cuda.synchronize()
        digests = [hashlib.sha256(x.contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:16]
                   for x in grads]
        print(json.dumps({"shape": label, "dtype": args.dtype, "part": args.part, "digests": digests}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
