#!/usr/bin/env python3
"""Where a training epoch of the PyTorch/CUDA port spends the card's time.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 tools/profile_torch_train.py [--model mf|lr|afm|din ...] [--epochs 20]
        [--compute-dtype bfloat16]
    python3 tools/profile_torch_train.py --model mf deepfm --train-mode sparse --epochs 2

On a synthetic ml-100k-format dataset at each preset's full width it runs,
under ``torch.profiler`` (CPU and CUDA activity), after one warm-up run each:

* ``Trainer.fit`` with per-epoch metrics (``run_experiment``'s training call);
* ``Trainer.fit`` without them (``cli/serve.py``'s training call);
  both under ``TrainConfig(compute_dtype=...)`` when ``--compute-dtype`` is
  given (``bfloat16``: DIN's head kernels take their bf16 path);
* for MF, ``MatrixFactorization.fast_fit`` (the fused kernel), float32; for
  LR, ``LogisticRegression.fast_fit`` in its compact and wide modes. DIN
  has no fused trainer: its two runs go through the fused DIN head kernels.

With ``--train-mode minibatch|stream|sparse`` it runs that mode's trainer
instead, over ``--batch-size`` rows a step (the preset's 8,192 by default):
``fit_minibatch``, ``fit_stream`` (the host arrays through the pinned
prefetch), or ``fit_minibatch_sparse`` with lazy Adam and with row-wise
AdaGrad (MF and DeepFM, the models with the sparse-row protocol).

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
from deeplearningrecommendationsystem_tpu_torch.experiments import (  # noqa: E402
    build_model,
    split_batches,
)
from deeplearningrecommendationsystem_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    Trainer,
    fit_minibatch,
    fit_minibatch_sparse,
    fit_stream,
)


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


def mode_runs(name: str, ds: MovieLens100K, epochs: int, dev, mode: str, batch_size: int):
    """(run name, rows, call) of the minibatch trainers of ``mode`` for ``name``."""
    cfg = PRESETS[name].replace(epochs=epochs)
    train = split_batches(cfg, ds, dev)["train"]
    host = tuple(t.cpu().numpy() for t in train[0]) if isinstance(train[0], tuple) else (
        train[0].cpu().numpy())
    host = (host, train[1].cpu().numpy())

    def trainer():
        return Trainer(build_model(cfg, ds), TrainConfig(
            learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay, epochs=epochs),
            device=dev)

    if mode == "minibatch":
        out = [("fit_minibatch", lambda: fit_minibatch(trainer(), cfg.seed, train, batch_size))]
    elif mode == "stream":
        out = [("fit_stream", lambda: fit_stream(trainer(), cfg.seed, host, batch_size,
                                                 seed=cfg.seed))]
    else:
        out = [(f"fit_minibatch_sparse {opt}", lambda opt=opt: fit_minibatch_sparse(
            trainer(), cfg.seed, train, batch_size, optimizer=opt))
            for opt in ("lazy_adam", "rowwise_adagrad")]
    return [(run, int(train[1].shape[0]), fn) for run, fn in out]


def runs(name: str, ds: MovieLens100K, epochs: int, dev, compute_dtype=None):
    """(run name, rows, call) of each run profiled for the preset ``name``."""
    cfg = PRESETS[name].replace(epochs=epochs)
    b = split_batches(cfg, ds, dev)
    train, valid, test = b["train"], b["valid"], b["test"]

    def fit(track: bool):
        model = build_model(cfg, ds).to(dev)
        tr = Trainer(model, TrainConfig(learning_rate=cfg.learning_rate,
                                        weight_decay=cfg.weight_decay, epochs=epochs,
                                        track_metrics=track, compute_dtype=compute_dtype),
                     device=dev)
        return lambda: tr.fit(train, valid=valid, test=test)

    model = build_model(cfg, ds).to(dev)
    params = {k: v.detach() for k, v in model.named_parameters()}
    out = [("Trainer.fit, track_metrics", fit(True)), ("Trainer.fit, no metrics", fit(False))]
    if name == "mf":
        out.append(("fast_fit float32", lambda: model.fast_fit(
            params, train[0], train[1], epochs, cfg.learning_rate, cfg.weight_decay, "float32")))
    elif name == "lr":
        for mode in ("compact", "wide"):
            out.append((f"fast_fit {mode}", lambda mode=mode: model.fast_fit(
                params, train[0], train[1], epochs, cfg.learning_rate, mode=mode)))
    return [(run, int(train[1].shape[0]), fn) for run, fn in out]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", nargs="+", choices=["mf", "lr", "afm", "din", "deepfm"],
                    default=["mf"])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--compute-dtype", choices=["bfloat16"], default=None,
                    help="Trainer.fit's compute dtype (default: float32 throughout)")
    ap.add_argument("--train-mode", choices=["minibatch", "stream", "sparse"],
                    help="profile that mode's trainer instead of the full-batch runs")
    ap.add_argument("--batch-size", type=int, default=PRESETS["mf"].batch_size,
                    help="rows a step of --train-mode")
    args = ap.parse_args()
    if args.train_mode is None and "deepfm" in args.model:
        ap.error("deepfm is profiled in a --train-mode only")
    if not torch.cuda.is_available():
        print("profile_torch_train: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        ds = MovieLens100K(write_ml100k_format(tmp, seed=0), seed=0)
    for name in args.model:
        todo = (mode_runs(name, ds, args.epochs, dev, args.train_mode, args.batch_size)
                if args.train_mode else runs(name, ds, args.epochs, dev, args.compute_dtype))
        for run, rows, fn in todo:
            print(json.dumps({"model": name, "compute_dtype": args.compute_dtype or "float32",
                              **profiled(run, fn, args.epochs), "rows": rows}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
