#!/usr/bin/env python3
"""How far the bf16 DIN head's forward lies from its plain version, seed by seed.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/probe_din_bf16_fwd_seeds.py [--seeds 0 1 2 3 4 5 6 7] [--rows 87900]

For each seed it draws ``chip_smoke.py``'s DIN inputs at the train batch (D
64, L 10, attention (128, 64, 1), fc (256, 128, 1); the history and target
from a generator of that seed, the MLPs as ``chip_smoke.py`` draws them), casts
them to bf16 as its bf16 rows do, and compares three sets of bf16 logits:

* ``kernel``: ``din_head_fused`` on the card (bf16 path);
* ``plain``: the plain bf16 head on the card (float32 sums, cuBLAS), the
  reference of ``chip_smoke.py``'s bf16 forward check;
* ``exact``: the plain head with every product summed in float64 from the
  same bf16 operands, then rounded to float32 (the same bf16 roundings of
  relu(z1), relu(z2), pooled, f1 and f2 where ``_mdot`` casts them).

For each pair it prints how many logits differ, and how many bf16 ulps the
farthest lies off (raw, and past ``chip_smoke.py``'s slack DIN_BF16_FWD_ATOL of
the largest |logit|, the check's measure), with a histogram of the ulps. Then
the card's name and power limit. It needs a card: without one it exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh  # noqa: E402


def ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bf16 ulps of each element of ``want`` (float32)."""
    want = want.float()
    _, e = torch.frexp(want.abs())
    return (got.float() - want).abs() / torch.ldexp(torch.ones_like(want), e - 8)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    u = ulps(got, want)
    return {"logits_off": int((got != want).sum()), "max_ulps": float(u.max()),
            "ulps_past_slack": cs.bf16_ulps(got, want),
            "histogram": {str(k): int((u.round() == k).sum()) for k in range(1, 5)}
            | {"5+": int((u.round() >= 5).sum())}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--rows", type=int, default=87_900)  # the DIN train batch of chip_smoke.py
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_din_bf16_fwd_seeds: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    L, D, A, F = 10, 64, cs.DIN_ATTENTION, cs.DIN_FC
    for seed in args.seeds:
        gen = torch.Generator(device=cs.DEVICE).manual_seed(seed)
        hist, tgt, att, fc, _ = cs.din_inputs(args.rows, L, D, A, F, gen)
        hist, tgt = hist.bfloat16(), tgt.bfloat16()
        weights = dh.din_head_weights(*([{k: v.bfloat16() for k, v in layer.items()} for layer in net]
                                        for net in (att, fc)), D)
        kernel = dh.din_head_fwd(hist, tgt, weights)
        plain = dh.din_head_fwd_plain(hist, tgt, weights)
        exact = cs.din_head_fwd_exact(hist, tgt, weights)
        print(json.dumps({"seed": seed, "rows": args.rows,
                          "kernel_vs_plain": compare(kernel, plain),
                          "kernel_vs_exact": compare(kernel, exact),
                          "plain_vs_exact": compare(plain, exact)}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
