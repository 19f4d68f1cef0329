"""CLI: one entry point for every model preset.

The JAX package's ``cli/run.py`` on the port, in place of the reference's 15
per-model scripts:

    python -m deeplearningrecommendationsystem_tpu_torch.cli.run --model deepfm
    python -m deeplearningrecommendationsystem_tpu_torch.cli.run --model mf --epochs 20
    python -m deeplearningrecommendationsystem_tpu_torch.cli.run --model dien --device cpu --json
    python -m deeplearningrecommendationsystem_tpu_torch.cli.run --list

The preset table carries each script's hyperparameters; flags override them.
``--device`` is ``cuda`` by default (raises where there is none) or ``cpu``
(the kernels' plain versions). ``--data`` defaults to ``$ML100K_PATH``, else
``dataset_example/ml-100k`` (the reference checkout's layout).
``--train-mode`` picks full-batch (the default), minibatch, stream or sparse
training (``--batch-size``, ``--sparse-optimizer``). ``--mesh d,m`` trains over
a ``(data, model)`` mesh of d * m ranks, one process each, under ``torchrun``:

    torchrun --nproc-per-node=4 -m deeplearningrecommendationsystem_tpu_torch.cli.run \
        --model deepfm --mesh 2,2 [--ep-strategy scatter]

each rank on ``cuda:{LOCAL_RANK}`` over NCCL (``--backend gloo`` for the host
transport, the only one for ``--device cpu``); d * m must equal the world
size, or the CLI exits with a message. Rank 0 prints the report.
``--fast-gathers`` sets the
two ``TrainConfig`` gather fields, which have no effect here (one kernel
pair). The JAX CLI's compilation cache is JAX's own and has no counterpart.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
from typing import Optional, Tuple

import torch.distributed as dist

from deeplearningrecommendationsystem_tpu_torch.configs.presets import PRESETS
from deeplearningrecommendationsystem_tpu_torch.experiments import DEFAULT_DATA, run_experiment
from deeplearningrecommendationsystem_tpu_torch.runtime.plotting import (
    plot_history,
    require_matplotlib,
)
from deeplearningrecommendationsystem_tpu_torch.runtime import distributed
from deeplearningrecommendationsystem_tpu_torch.runtime.profiler import debug_nans, trace


def mesh_axes(flag: Optional[str], backend: str) -> Optional[Tuple[int, int]]:
    """``--mesh d,m`` as (d, m), after opening the process group (from
    ``torchrun``'s environment) if there is none yet; exits with a message
    where d * m is not the number of ranks."""
    if not flag:
        return None
    try:
        data, model = (int(v) for v in flag.split(","))
    except ValueError:
        raise SystemExit(f"--mesh {flag!r}: give the axes as DATA,MODEL, e.g. 2,2")
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        distributed.initialize(backend=backend)
    start = f"start it under torchrun --nproc-per-node={data * model}"
    if not dist.is_initialized():
        raise SystemExit(f"--mesh {data},{model}: no process group; {start}")
    if data * model != dist.get_world_size():
        raise SystemExit(f"--mesh {data},{model} needs {data * model} ranks and this run has "
                         f"{dist.get_world_size()}: {start}")
    return data, model


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="CTR/ranking experiments on the PyTorch/CUDA port")
    ap.add_argument("--model", choices=sorted(PRESETS), help="model preset to run")
    ap.add_argument("--list", action="store_true", help="list presets and exit")
    ap.add_argument("--data", default=DEFAULT_DATA, help="path to ml-100k")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--epochs", type=int, help="override preset epochs")
    ap.add_argument("--lr", type=float, help="override learning rate")
    ap.add_argument("--weight-decay", type=float, help="override weight decay")
    ap.add_argument("--k", type=int, help="override ranking cutoff")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--compute-dtype",
        choices=["float32", "bfloat16"],
        help="matmul compute dtype (f32 master weights); default = preset's",
    )
    ap.add_argument(
        "--no-epoch-metrics",
        action="store_true",
        help="skip per-epoch metric tracking (fastest pure-training mode)",
    )
    ap.add_argument("--json", action="store_true", help="emit a JSON summary")
    ap.add_argument(
        "--plot",
        metavar="PATH",
        help="save training-curve figure (GDCF_Final.py:99-117 analogue) to PATH "
        "(needs matplotlib)",
    )
    ap.add_argument(
        "--mesh",
        metavar="DATA,MODEL",
        help="device mesh axes: DP over DATA, the id tables row-sharded over MODEL "
        "(EP); DATA * MODEL ranks under torchrun",
    )
    ap.add_argument(
        "--backend", choices=["nccl", "gloo"], default="nccl",
        help="the ranks' transport with --mesh (gloo for --device cpu)",
    )
    ap.add_argument(
        "--ep-strategy",
        choices=["psum", "scatter"],
        default="psum",
        help="EP gather strategy (with --mesh)",
    )
    ap.add_argument(
        "--train-mode",
        choices=["fullbatch", "minibatch", "sparse", "stream"],
        help="fullbatch = reference parity regime; minibatch = shuffled SGD; "
        "sparse = minibatch with row-sparse embedding updates (mf/deepfm); "
        "stream = host-streamed minibatches with device prefetch (data/stream.py)",
    )
    ap.add_argument("--batch-size", type=int, help="minibatch/sparse batch size")
    ap.add_argument(
        "--sparse-optimizer", choices=["lazy_adam", "rowwise_adagrad"],
        help="row optimizer for --train-mode sparse",
    )
    ap.add_argument(
        "--augru", action="store_true",
        help="DIEN extension: AUGRU interest-evolution layer (the reference "
        "uses a plain GRU, model/dien.py:47,61)",
    )
    ap.add_argument(
        "--aux-weight", type=float,
        help="DIEN extension: auxiliary next-behavior loss weight (0 = off)",
    )
    ap.add_argument(
        "--fast-gathers", action="store_true",
        help="the JAX bench's gather routes (matmul_gather_bwd, onehot_gather); "
        "accepted, no effect: every lookup is the gather kernel pair",
    )
    ap.add_argument("--profile", metavar="DIR",
                    help="capture a torch.profiler trace to DIR/trace.json and the "
                    "program's spans and counters to DIR/spans.json")
    ap.add_argument(
        "--debug-nans", action="store_true",
        help="fail on a NaN gradient (autograd anomaly mode; checks the backward)",
    )
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)

    if args.list:
        for name, cfg in sorted(PRESETS.items()):
            print(
                f"{name:14s} family={cfg.family:8s} negatives={cfg.negatives} "
                f"lr={cfg.learning_rate} wd={cfg.weight_decay} epochs={cfg.epochs}"
            )
        return 0
    if not args.model:
        ap.error("--model is required (or --list)")
    mesh = mesh_axes(args.mesh, args.backend)

    overrides = {"seed": args.seed}
    if mesh is not None:
        overrides.update(mesh_shape=mesh, ep_strategy=args.ep_strategy)
    if args.epochs is not None:
        overrides["epochs"] = args.epochs
    if args.lr is not None:
        overrides["learning_rate"] = args.lr
    if args.weight_decay is not None:
        overrides["weight_decay"] = args.weight_decay
    if args.k is not None:
        overrides["k"] = args.k
    if args.no_epoch_metrics:
        overrides["track_metrics"] = False
    if args.compute_dtype:
        overrides["compute_dtype"] = (
            None if args.compute_dtype == "float32" else args.compute_dtype
        )
    if args.train_mode:
        overrides["train_mode"] = args.train_mode
    if args.fast_gathers:
        overrides["matmul_gather_bwd"] = True
        overrides["onehot_gather"] = True
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.sparse_optimizer:
        overrides["sparse_optimizer"] = args.sparse_optimizer
    if args.augru or args.aux_weight is not None:
        if args.model != "dien":
            ap.error("--augru/--aux-weight are DIEN extensions")
        if args.aux_weight is not None:
            overrides["aux_weight"] = args.aux_weight
        if args.augru:
            kw = dict(PRESETS[args.model].model_kwargs)
            kw["use_augru"] = True
            overrides["model_kwargs"] = kw

    cfg = PRESETS[args.model].replace(**overrides)
    device = distributed.local_device(None if args.device == "cuda" else args.device)
    if args.plot:
        require_matplotlib()  # before training, not after it
    stack = contextlib.ExitStack()
    if args.debug_nans:
        stack.enter_context(debug_nans(True))
    if args.profile:
        stack.enter_context(trace(args.profile))
    with stack:
        result = run_experiment(cfg, data_path=args.data, device=device, verbose=not args.json)
    if not distributed.is_primary():
        return 0  # rank 0 reports
    if args.plot:
        plot_history(result.history, args.plot, title=f"{result.model} training curves")
        if not args.json:
            print(f"saved training curves to {args.plot}")
    if args.json:
        print(
            json.dumps(
                {
                    "model": result.model,
                    "final": result.final_metrics(),
                    "ranking": result.ranking,
                    "examples_per_sec": result.examples_per_sec,
                    "train_time_s": result.train_time_s,
                }
            )
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
