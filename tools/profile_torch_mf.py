#!/usr/bin/env python3
"""Where an MF training epoch of the PyTorch/CUDA port spends the card's time.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/profile_torch_mf.py [--epochs 20]

On a synthetic ml-100k-format dataset at the MF preset's full width it runs,
under ``torch.profiler`` (CPU and CUDA activity), after one warm-up run each:

* ``Trainer.fit`` with per-epoch metrics (``run_experiment``'s training call);
* ``Trainer.fit`` without them (``cli/serve.py``'s training call);
* ``MatrixFactorization.fast_fit`` (the fused kernel), float32.

For each it prints one JSON line: the wall time of the call (host clock, after
a synchronise) with and without the profiler, the summed device time of every
kernel, the device's idle share under the profiler (1 - device time / wall
time), and the kernels that took most device time. Then the card's name and power limit. It needs a card: without one it
exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.experiments import build_model  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.sampling import NegativeSampler  # noqa: E402
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer  # noqa: E402


def batches(ds: MovieLens100K, cfg, device):
    """The three batches ``run_experiment`` builds for ``cfg``."""
    sampler = NegativeSampler(ds.seen_mask(ds.train, ds.valid, ds.test), seed=cfg.seed,
                              device=device)
    out = []
    for split, n in zip((ds.train, ds.valid, ds.test), cfg.negatives):
        c = MovieLens100K.concat_splits(split, sampler.sample(n))
        out.append(((torch.from_numpy(c["user"]).to(device), torch.from_numpy(c["item"]).to(device)),
                    torch.from_numpy(c["rating"]).to(device)))
    return out


def device_us(event) -> float:
    return float(getattr(event, "self_device_time_total", None)
                 or getattr(event, "self_cuda_time_total", 0.0))


def profiled(name: str, fn, epochs: int) -> dict:
    fn()  # warm-up: builds the kernels, fills the allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3  # the profiler adds host time per op
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side activity only; a user annotation (Optimizer.step) spans kernels counted already
    kernels = [e for e in prof.key_averages() if device_us(e) > 0 and e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    return {
        "run": name, "epochs": epochs, "wall_ms": wall_ms, "wall_ms_per_epoch": wall_ms / epochs,
        "wall_ms_per_epoch_unprofiled": plain_wall_ms / epochs,
        "device_ms": busy_ms, "device_ms_per_epoch": busy_ms / epochs,
        "idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels": [{"name": e.key[:90], "calls": e.count, "device_ms": device_us(e) / 1e3}
                        for e in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_mf: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = PRESETS["mf"].replace(epochs=args.epochs)
    with tempfile.TemporaryDirectory() as tmp:
        ds = MovieLens100K(write_ml100k_format(tmp, seed=0), seed=0)
    train, valid, test = batches(ds, cfg, dev)

    def fit(track: bool):
        model = build_model(cfg, ds).to(dev)
        tr = Trainer(model, TrainConfig(learning_rate=cfg.learning_rate,
                                        weight_decay=cfg.weight_decay, epochs=args.epochs,
                                        track_metrics=track), device=dev)
        return lambda: tr.fit(train, valid=valid, test=test)

    model = build_model(cfg, ds).to(dev)
    params = {k: v.detach() for k, v in model.named_parameters()}
    runs = [
        ("Trainer.fit, track_metrics", fit(True)),
        ("Trainer.fit, no metrics", fit(False)),
        ("fast_fit float32", lambda: model.fast_fit(params, train[0], train[1], args.epochs,
                                                    cfg.learning_rate, cfg.weight_decay,
                                                    "float32")),
    ]
    for name, fn in runs:
        print(json.dumps({**profiled(name, fn, args.epochs), "rows": int(train[1].shape[0])}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
