"""Serving CLI: train a model preset on the card and serve it over HTTP.

    # train the MF preset for 20 epochs on ml-100k-format files and serve on :8080
    python -m deeplearningrecommendationsystem_tpu_torch.cli.serve --model mf \\
        --data path/to/ml-100k --epochs 20 --port 8080

    curl 'localhost:8080/v1/recommend?user=12&k=10'
    curl -X POST localhost:8080/v1/recommend -d '{"users": [1, 2, 3], "k": 5}'

The JAX package's ``cli/serve.py`` on the port: train through
``run_experiment``, then keep the model on the device behind
``RecommenderServer``. ``--device cpu`` runs everything on the CPU (the
kernels' plain versions). Loading a checkpoint (``--checkpoint``) and
row-sharded serving (``--mesh``) are not ported yet and exit with a message.
"""

from __future__ import annotations

import argparse

from deeplearningrecommendationsystem_tpu_torch.configs.presets import PRESETS


def build_server(args):
    """Train the model and wrap it in a RecommenderServer (not started)."""
    from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K
    from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
    from deeplearningrecommendationsystem_tpu_torch.experiments import build_model, run_experiment
    from deeplearningrecommendationsystem_tpu_torch.server import RecommenderServer
    from deeplearningrecommendationsystem_tpu_torch.serving import Recommender

    if args.checkpoint:
        raise SystemExit("--checkpoint: loading checkpoints is not ported yet "
                         "(ROADMAP.md §1 item 13)")
    if args.mesh:
        raise SystemExit("--mesh: row-sharded serving is not ported yet (ROADMAP.md §1 item 13)")
    device = resolve_device(args.device)
    cfg = PRESETS[args.model]
    if args.epochs is not None:
        cfg = cfg.replace(epochs=args.epochs)
    cfg = cfg.replace(track_metrics=False, seed=args.seed)
    data = MovieLens100K(args.data, seed=args.seed)
    seen = data.seen_mask(data.train, data.valid, data.test) if args.exclude_seen else None

    res = run_experiment(cfg, data=data, device=device)
    model = build_model(cfg, data)
    model.load_state_dict(res.params)
    rec = Recommender(model, res.ctx, seen=seen, device=device)
    return RecommenderServer(rec, host=args.host, port=args.port)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Serve top-K recommendations over HTTP")
    ap.add_argument("--model", choices=sorted(PRESETS), required=True)
    ap.add_argument("--data", required=True, help="directory with ml-100k-format u.data, u.user, u.item")
    ap.add_argument("--epochs", type=int, help="override preset epochs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--checkpoint", help="load params instead of training (not ported yet)")
    ap.add_argument("--mesh", help="device mesh axes 'data,model' (not ported yet)")
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
    args = parser().parse_args(argv)
    server = build_server(args)
    print(f"serving {args.model} on http://{args.host}:{server.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
