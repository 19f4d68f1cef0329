#!/usr/bin/env python3
"""Device time of the fused DIN head's float32 backward, to compare two trees.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/time_din_bwd.py [--root OTHER_CHECKOUT]

On ``chip_smoke.py``'s inputs (``din_inputs_as``, float32, a generator of seed
0) it times ``ops/din_head.py::din_head_bwd`` of the tree at ``--root`` (this
one by default; its kernels built from its own ``csrc/``) at the DIN train
batch (87,900 rows, history 10, the preset's nets), at 16,384 rows of history
64 and at the train batch's rows at ragged widths (``DIN_RAGGED``), twice each
(``chip_smoke.py``'s ``time_ms``: CUDA events over back-to-back calls, inputs
warm), and prints one JSON line of milliseconds, then the card's name and
power limit. Compare trees only within one call, in turns.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_din_bwd: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke as cs
    from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh

    out = {"root": str(args.root)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, dims in (("train", 87_900, (10, 64, cs.DIN_ATTENTION, cs.DIN_FC)),
                           ("history_64", 16_384, (64, 64, cs.DIN_ATTENTION, cs.DIN_FC)),
                           ("ragged", 87_900, cs.DIN_RAGGED)):
        hist, tgt, _, _, g, w = cs.din_inputs_as(torch.float32, B, *dims, gen)
        out[label] = [cs.time_ms(lambda: dh.din_head_bwd(hist, tgt, w, g)) for _ in range(2)]
        del hist, tgt, g, w
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
