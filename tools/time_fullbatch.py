#!/usr/bin/env python3
"""Device time of the fused full-batch trainers, to compare two trees.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/time_fullbatch.py [--root OTHER_CHECKOUT] [--kernels]

On ``chip_smoke.py``'s synthetic data (seed 0) it times the tree at
``--root`` (this one by default; its kernels built from its own ``csrc/``):
``mf_fullbatch_train`` on the MF train batch (229,350 rows) at D 64 in
float32 and bfloat16 and at D 256 in float32, and
``lr_fullbatch_train_compact`` and ``lr_fullbatch_train`` (wide) on the LR
train batch (69,040 rows) as ``fast_fit`` feeds them, each twice, as
``chip_smoke.py`` does (``time_ms`` over calls of 20 epochs: CUDA events over
back-to-back calls, inputs warm), in ms per epoch. Beside each, the sha256 of
a 5-epoch call's outputs (tables or weights, then losses), to tell whether two
trees give the same bits. With ``--kernels`` each
also runs one 20-epoch call under ``torch.profiler`` and gives the device
microseconds of each kernel it launched (the trainer's own and the segment
builder's). One JSON line, then the card's name and power limit. Compare trees
only within one call, in turns.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

EPOCHS, CHECK_EPOCHS = 20, 5


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_fullbatch: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.root.resolve()))
    import chip_smoke as cs
    from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
    from deeplearningrecommendationsystem_tpu_torch.experiments import build_model, split_batches
    from deeplearningrecommendationsystem_tpu_torch.ops import lr_epoch as lre
    from deeplearningrecommendationsystem_tpu_torch.ops import mf_epoch as mfe

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": str(args.root)}
    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.make_dataset(tmp)
        (uid, iid), y = split_batches(PRESETS["mf"], ds, "cuda")["train"]
        lr_cfg = PRESETS["lr"]
        x, ly = split_batches(lr_cfg, ds, "cuda")["train"]
        lr_model = build_model(lr_cfg, ds).to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    U, I = ds.num_users, ds.num_items
    for label, D, dtype in (("mf_f32_d64", 64, "float32"), ("mf_bf16_d64", 64, "bfloat16"),
                            ("mf_f32_d256", 256, "float32")):
        pu0 = 0.1 * torch.randn((U, D), generator=gen, device="cuda")
        pi0 = 0.1 * torch.randn((I, D), generator=gen, device="cuda")
        a = (uid, iid, y, pu0, pi0)
        call = lambda: mfe.mf_fullbatch_train(*a, EPOCHS, 0.01, 1e-5, dtype)  # noqa: E731
        out[label] = {"ms": [cs.time_ms(call) / EPOCHS for _ in range(2)],
                      "sha256": digest(mfe.mf_fullbatch_train(*a, CHECK_EPOCHS, 0.01, 1e-5, dtype))}
        if args.kernels:
            out[label]["kernel_us"] = kernel_us(call)
    for mode, fn, extra in (("compact", lre.lr_fullbatch_train_compact, (U, I)),
                            ("wide", lre.lr_fullbatch_train, ())):
        a = lr_model.fused_inputs(lr_model.params(), x, ly, mode)
        call = lambda: fn(*a, EPOCHS, lr_cfg.learning_rate, *extra)  # noqa: E731
        out[f"lr_{mode}"] = {"ms": [cs.time_ms(call) / EPOCHS for _ in range(2)],
                             "sha256": digest(fn(*a, CHECK_EPOCHS, lr_cfg.learning_rate, *extra))}
        if args.kernels:
            out[f"lr_{mode}"]["kernel_us"] = kernel_us(call)
    print(json.dumps(out), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
