"""CLI for the classic-CF scripts (UserCF / ItemCF / GDCF).

The JAX package's ``cli/cf.py`` on the port, one entry point over the
reference's three standalone scripts and the same u?.base / u?.test folds:

    python -m deeplearningrecommendationsystem_tpu_torch.cli.cf usercf
    python -m deeplearningrecommendationsystem_tpu_torch.cli.cf itemcf --neighbors 10 --top-n 20
    python -m deeplearningrecommendationsystem_tpu_torch.cli.cf gdcf --fold u1 --plot curves.png

Defaults match each reference script: UserCF/ItemCF use fold ``ua``, 10
neighbours, top-20 recommendations (UserCF_Final.py:30,57); GDCF uses fold
``u1``, embedding 100, Adam lr=0.01, 10 iterations, Recall/Precision/F1@50
per iteration plus the training-curve figure (GDCF_Final.py:26-28,66,99-117).
``--device`` is ``cuda`` by default (raises where there is none) or ``cpu``;
``--data`` defaults to ``$ML100K_PATH``, else ``dataset_example/ml-100k``.
``--plot`` needs matplotlib and says so before any work.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from deeplearningrecommendationsystem_tpu_torch.cf import (
    cf_eval,
    gdcf_train,
    item_cf_recommend,
    load_base_test,
    user_cf_recommend,
)
from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.experiments import DEFAULT_DATA
from deeplearningrecommendationsystem_tpu_torch.runtime.plotting import (
    plot_history,
    require_matplotlib,
)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="classic CF (UserCF / ItemCF / GDCF)")
    ap.add_argument("algo", choices=["usercf", "itemcf", "gdcf"])
    ap.add_argument("--data", default=DEFAULT_DATA, help="path to ml-100k")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--fold", help="u1..u5 / ua / ub (default: ua, gdcf: u1)")
    ap.add_argument("--neighbors", type=int, default=10, help="neighborhood size")
    ap.add_argument("--top-n", type=int, default=20, help="recommendations per user")
    ap.add_argument("--embedding-size", type=int, default=100, help="gdcf factors")
    ap.add_argument("--lr", type=float, default=0.01, help="gdcf Adam lr")
    ap.add_argument("--iterations", type=int, default=10, help="gdcf iterations")
    ap.add_argument("--k", type=int, default=50, help="gdcf ranking cutoff")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true", help="emit a JSON summary")
    ap.add_argument(
        "--plot",
        metavar="PATH",
        help="gdcf: save the training-curve figure (GDCF_Final.py:99-117) to PATH "
        "(needs matplotlib)",
    )
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.plot and args.algo == "gdcf":
        require_matplotlib()  # before the work, not after it
    fold = args.fold or ("u1" if args.algo == "gdcf" else "ua")
    matrix, test_lists = load_base_test(args.data, fold)

    if args.algo == "gdcf":
        history, _ = gdcf_train(
            matrix,
            embedding_size=args.embedding_size,
            learning_rate=args.lr,
            iterations=args.iterations,
            top_k=args.k,
            seed=args.seed,
            device=device,
        )
        losses = history["loss"].cpu().numpy()
        recs = history["rec"].cpu().numpy()
        recalls, precisions, f1s = [], [], []
        for it in range(args.iterations):
            r, p, f1 = cf_eval(recs[it], test_lists)
            recalls.append(r)
            precisions.append(p)
            f1s.append(f1)
            if not args.json:
                print(
                    f"iter {it + 1:3d}  loss={losses[it]:.4f}  "
                    f"recall@{args.k}={r:.4f}  precision@{args.k}={p:.4f}  f1={f1:.4f}"
                )
        if args.plot:
            plot_history(
                {
                    "loss": losses,
                    f"recall@{args.k}": np.asarray(recalls),
                    f"precision@{args.k}": np.asarray(precisions),
                    "f1": np.asarray(f1s),
                },
                args.plot,
                title=f"GDCF ({fold})",
            )
            if not args.json:
                print(f"saved training curves to {args.plot}")
        summary = {
            "algo": "gdcf",
            "fold": fold,
            "loss": losses.tolist(),
            "recall": recalls[-1],
            "precision": precisions[-1],
            "f1": f1s[-1],
        }
    else:
        recommend = user_cf_recommend if args.algo == "usercf" else item_cf_recommend
        rec = recommend(matrix, k_neighbors=args.neighbors, top_n=args.top_n,
                        device=device).cpu().numpy()
        recall, precision, f1 = cf_eval(rec, test_lists)
        summary = {
            "algo": args.algo,
            "fold": fold,
            "recall": recall,
            "precision": precision,
            "f1": f1,
        }
        if not args.json:
            print(
                f"{args.algo} ({fold}, k={args.neighbors}, top-{args.top_n}): "
                f"recall={recall:.4f}  precision={precision:.4f}  f1={f1:.4f}"
            )

    if args.json:
        print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
