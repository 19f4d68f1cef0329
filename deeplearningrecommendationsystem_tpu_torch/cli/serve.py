"""Serving CLI: train a model preset on the card and serve it over HTTP.

    # train the MF preset for 20 epochs on ml-100k-format files and serve on :8080
    python -m deeplearningrecommendationsystem_tpu_torch.cli.serve --model mf \\
        --data path/to/ml-100k --epochs 20 --port 8080

    curl 'localhost:8080/v1/recommend?user=12&k=10'
    curl -X POST localhost:8080/v1/recommend -d '{"users": [1, 2, 3], "k": 5}'

    # serve the params of a runtime/checkpoint.py checkpoint instead of training
    python -m deeplearningrecommendationsystem_tpu_torch.cli.serve --model mf \\
        --data path/to/ml-100k --checkpoint ckpt/

The JAX package's ``cli/serve.py`` on the port: train through
``run_experiment`` (or rebuild the serving context with a one-epoch
``run_experiment``, as the JAX CLI does, and load the latest checkpoint's
``state["params"]`` through ``Recommender.from_checkpoint``), then keep the
model on the device behind ``RecommenderServer``.
``--device cpu`` runs everything on the CPU (the kernels' plain versions).

``--mesh d,m`` serves from row-sharded tables, one process a rank under
``torchrun`` (d * m must be the world size, or the CLI exits with a message):

    torchrun --nproc-per-node=2 -m deeplearningrecommendationsystem_tpu_torch.cli.serve \
        --model mf --data path/to/ml-100k --mesh 1,2

Every rank trains with the tables left sharded and builds a
``ShardedRecommender``. Rank 0 runs the HTTP server; each request it answers
is first broadcast to the other ranks as an (op, users, k) record, and the
other ranks run :func:`worker_loop`, making the same call, so every rank
enters the same collectives. Rank 0's shutdown broadcasts a stop record.
"""

from __future__ import annotations

import argparse
import threading

from deeplearningrecommendationsystem_tpu_torch.cli.run import mesh_axes
from deeplearningrecommendationsystem_tpu_torch.configs.presets import PRESETS
from deeplearningrecommendationsystem_tpu_torch.parallel import collectives
from deeplearningrecommendationsystem_tpu_torch.runtime import distributed


class BroadcastingRecommender:
    """Rank 0's recommender under a mesh: broadcasts each call as an (op,
    users, k) record before making it (one call at a time: the HTTP server's
    threads take turns), so the other ranks' :func:`worker_loop` makes it too."""

    def __init__(self, rec):
        self.rec = rec
        self._lock = threading.Lock()

    @property
    def shape(self):
        return self.rec.shape

    def refresh(self) -> None:
        self.rec.refresh()

    def _call(self, op: str, users, k):
        with self._lock:
            collectives.broadcast_object((op, users, k))
            return _run(self.rec, op, users, k)

    def top_k_with_scores(self, k: int, users=None):
        return self._call("top_k", None if users is None else [int(u) for u in users], k)

    def top_k(self, k: int, users=None):
        return self.top_k_with_scores(k, users)[0]

    def score(self, user: int, items):
        return self._call("score", (int(user), [int(i) for i in items]), None)

    def stop(self) -> None:
        with self._lock:
            collectives.broadcast_object(("stop", None, None))


def _run(rec, op: str, users, k):
    if op == "top_k":
        return rec.top_k_with_scores(k, users)
    if op == "score":
        return rec.score(*users)
    raise ValueError(f"unknown serving op {op!r}")


def worker_loop(rec) -> int:
    """A rank other than 0: make every call rank 0 broadcasts, until its stop
    record; returns the number of calls made."""
    calls = 0
    while True:
        op, users, k = collectives.broadcast_object()
        if op == "stop":
            return calls
        _run(rec, op, users, k)
        calls += 1


def build_server(args):
    """Train the model (or load ``--checkpoint``) and wrap it in a
    RecommenderServer (not started)."""
    from deeplearningrecommendationsystem_tpu_torch.server import RecommenderServer

    return RecommenderServer(build_recommender(args), host=args.host, port=args.port)


def build_recommender(args):
    """The trained model's recommender: a ``Recommender``; under ``--mesh`` a
    ``ShardedRecommender``, wrapped in a :class:`BroadcastingRecommender` on
    rank 0."""
    from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K
    from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
    from deeplearningrecommendationsystem_tpu_torch.experiments import build_model, run_experiment
    from deeplearningrecommendationsystem_tpu_torch.serving import Recommender, ShardedRecommender

    device = resolve_device(args.device)
    cfg = PRESETS[args.model]
    if args.epochs is not None:
        cfg = cfg.replace(epochs=args.epochs)
    cfg = cfg.replace(track_metrics=False, seed=args.seed)
    data = MovieLens100K(args.data, seed=args.seed)
    seen = data.seen_mask(data.train, data.valid, data.test) if args.exclude_seen else None

    mesh = mesh_axes(args.mesh, getattr(args, "backend", "nccl"))
    if mesh is not None:
        from deeplearningrecommendationsystem_tpu_torch.parallel import (
            make_mesh,
            shard_model_tables,
        )

        # check the model can serve sharded BEFORE the training run:
        # sharded_catalog_topk needs serving_factors (factored scores) or the
        # sparse_tables + spec feature protocol (parallel/serving.py)
        model = build_model(cfg, data)
        if not (hasattr(model, "serving_factors")
                or (hasattr(model, "sparse_tables") and hasattr(model, "spec"))):
            raise SystemExit(
                f"--mesh: {args.model} cannot serve from sharded tables (needs "
                "serving_factors or the sparse_tables+spec protocol; sequence models "
                "must serve dense -- drop --mesh)")
        # EP end to end: train sharded, keep the tables sharded, serve sharded
        cfg = cfg.replace(mesh_shape=mesh, unshard_params=False)
        if args.checkpoint:
            ctx = run_experiment(cfg.replace(epochs=1, mesh_shape=None, unshard_params=True),
                                 data=data, device=device).ctx
            dense = Recommender.from_checkpoint(model, args.checkpoint, ctx, device=device)
            params, _, _ = shard_model_tables(dict(dense.model.named_parameters()),
                                              make_mesh(*mesh))
            params = {k: v.detach() for k, v in params.items()}
        else:
            res = run_experiment(cfg, data=data, device=device)
            params, ctx = res.params, res.ctx
        rec = ShardedRecommender(model, params, ctx, make_mesh(*mesh), seen=seen, device=device)
        return BroadcastingRecommender(rec) if distributed.is_primary() else rec
    if args.checkpoint:
        # the same ServingContext run_experiment would have used
        ctx = run_experiment(cfg.replace(epochs=1), data=data, device=device).ctx
        rec = Recommender.from_checkpoint(build_model(cfg, data), args.checkpoint, ctx,
                                          seen=seen, device=device)
    else:
        res = run_experiment(cfg, data=data, device=device)
        model = build_model(cfg, data)
        model.load_state_dict(res.params)
        rec = Recommender(model, res.ctx, seen=seen, device=device)
    return rec


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Serve top-K recommendations over HTTP")
    ap.add_argument("--model", choices=sorted(PRESETS), required=True)
    ap.add_argument("--data", required=True, help="directory with ml-100k-format u.data, u.user, u.item")
    ap.add_argument("--epochs", type=int, help="override preset epochs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--checkpoint",
                    help="load params from this runtime/checkpoint.py directory instead of training")
    ap.add_argument(
        "--mesh",
        help="device mesh axes 'data,model', e.g. 1,2: train with row-sharded embedding "
        "tables (EP) and serve them SHARDED via ShardedRecommender, one process a rank "
        "under torchrun (factored + feature models; sequence models must serve dense)",
    )
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                    help="the ranks' transport with --mesh (gloo for --device cpu)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument(
        "--no-exclude-seen",
        dest="exclude_seen",
        action="store_false",
        help="do not filter already-interacted items from recommendations",
    )
    return ap


def main(argv=None) -> int:
    from deeplearningrecommendationsystem_tpu_torch.server import RecommenderServer
    from deeplearningrecommendationsystem_tpu_torch.serving import ShardedRecommender

    args = parser().parse_args(argv)
    rec = build_recommender(args)
    if isinstance(rec, ShardedRecommender):  # a rank other than 0 under --mesh
        worker_loop(rec)
        return 0
    server = RecommenderServer(rec, host=args.host, port=args.port)
    print(f"serving {args.model} on http://{args.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        if isinstance(server.recommender, BroadcastingRecommender):
            server.recommender.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
