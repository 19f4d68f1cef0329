"""The rank functions of the port's multi-rank CPU tests.

Each runs in a process that ``runtime/distributed.py::spawn`` starts with the
``spawn`` method, over Gloo on the CPU. A spawned child re-imports the module
of its function, so this module imports the port and never JAX (the test
files import both). Each function takes (rank, world, ...) and returns NumPy
arrays and plain values for the test to hold against the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from deeplearningrecommendationsystem_tpu_torch import models
from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models import ServingContext
from deeplearningrecommendationsystem_tpu_torch.ops import embedding as ops_embedding
from deeplearningrecommendationsystem_tpu_torch.parallel import (
    collectives,
    ep,
    make_mesh,
    pad_and_shard,
    serving as pserving,
    shard_table,
    sharded_gather,
    sharded_gather_scatter,
)
from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_group,
    mesh_shape,
)
from deeplearningrecommendationsystem_tpu_torch.runtime import distributed
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax


def np_tree(tree):
    """Tensors -> NumPy arrays through dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(np_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def build(kind: str, U: int, I: int, kwargs: Dict[str, Any], jax_params=None):
    """The port's MF, DeepFM or DIEN at (U, I), with the JAX params where
    given."""
    if kind == "mf":
        model = models.MatrixFactorization(U, I, **kwargs, device="cpu")
    elif kind == "dien":
        model = models.DIEN(I, **kwargs, device="cpu")
    else:
        model = models.DeepFM(FeatureSpec(num_users=U, num_items=I), **kwargs, device="cpu")
    return model if jax_params is None else params_from_jax(model, jax_params)


class Counts:
    """Counts the calls of the gather pair's and the top-k pair's wrappers on
    this rank (the wrappers a CUDA tensor would launch the kernels through);
    a rank process counts until it exits."""

    NAMES = ("gather_rows", "onehot_grad", "topk_serve_matmul", "topk_scores")

    def __init__(self):
        self.n = dict.fromkeys(self.NAMES, 0)
        for mod, attr, name in ((ops_embedding, "gather_rows_kernel", "gather_rows"),
                                (ops_embedding, "onehot_grad", "onehot_grad"),
                                (pserving, "topk_serve_matmul", "topk_serve_matmul"),
                                (pserving, "topk_scores", "topk_scores")):
            setattr(mod, attr, self._counted(getattr(mod, attr), name))

    def _counted(self, fn, name):
        def wrapper(*a, **kw):
            self.n[name] += 1
            return fn(*a, **kw)
        return wrapper

    def take(self) -> Dict[str, int]:
        out, self.n = self.n, dict.fromkeys(self.NAMES, 0)
        return out


def collectives_rank(rank: int, world: int) -> Dict[str, Any]:
    """The collectives on a (1, world) mesh, their transposes under autograd,
    and the transport rule."""
    mesh = make_mesh(1, world)
    group = axis_group(mesh, MODEL_AXIS)
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * rank
    out = {"shape": mesh_shape(mesh), "sum": collectives.sum_over(x, group).numpy(),
           "gather": collectives.all_gather_tiled(x, group).numpy(),
           "scatter": collectives.reduce_scatter_tiled(
               torch.arange(2 * world, dtype=torch.float32) + rank, group).numpy()}
    # the transposes: d/dx of sum(w * f(x)) for each collective
    for name, fn, w_rows in (("psum", collectives.psum, 3),
                             ("all_gather", collectives.all_gather, 3 * world),
                             ("psum_scatter", collectives.psum_scatter, 3)):
        xi = (torch.arange(6 * (world if name == "psum_scatter" else 1), dtype=torch.float32)
              .reshape(-1, 2) + rank).requires_grad_(True)
        w = torch.arange(2 * w_rows, dtype=torch.float32).reshape(w_rows, 2) + 100 * rank
        (fn(xi, group) * w).sum().backward()
        out[f"grad_{name}"] = xi.grad.numpy()
    collectives.reset_stats()
    collectives.sum_over(torch.ones(4), group)
    out["stats"] = dict(collectives.STATS)
    out["primary"] = distributed.is_primary()
    out["slice"] = distributed.host_local_slice(11)
    # the CLIs' --mesh against this world's size
    from deeplearningrecommendationsystem_tpu_torch.cli.run import mesh_axes

    out["mesh_ok"] = mesh_axes(f"1,{world}", "gloo")
    try:
        mesh_axes("2,2", "gloo")
    except SystemExit as e:
        out["mesh_wrong"] = str(e)
    return out


def trainer_rank(rank: int, world: int, mesh_axes, strategy: str, cases: List[dict],
                 epochs: int) -> Dict[str, Any]:
    """Trainer.fit of each case on this rank's rows of its splits (with the
    model's fused auxiliary loss where the case gives ``aux_weight``); returns
    the history, extras and final params of each case, and the wrappers'
    calls."""
    mesh = make_mesh(*mesh_axes)
    shape = mesh_shape(mesh)
    cut = shape["data"] > 1 or (strategy == "scatter" and shape["model"] > 1)
    counts = Counts()
    results = {}
    for case in cases:
        model = build(case["kind"], case["U"], case["I"], case["kwargs"], case["params"])
        aux = case.get("aux_weight")
        trainer = Trainer(model, TrainConfig(learning_rate=case["lr"], weight_decay=case["wd"],
                                             epochs=epochs, mesh=mesh, ep_strategy=strategy),
                          device="cpu", aux_loss_fn="model" if aux else None,
                          aux_weight=aux or 1.0)
        splits, weights = {}, {}
        for name, (b, y) in case["splits"].items():
            b = tuple(torch.from_numpy(a) for a in b) if isinstance(b, tuple) else torch.from_numpy(b)
            y = torch.from_numpy(y)
            if cut:
                b, y, weights[name] = pad_and_shard(b, y, mesh, None, strategy)
            splits[name] = (b, y)
        counts.take()
        res = trainer.fit(splits["train"], valid=splits["valid"], test=splits["test"],
                          weights=weights or None)
        results[case["name"]] = {"history": np_tree(res.history), "extras": res.extras,
                                 "params": np_tree(res.params), "calls": counts.take(),
                                 "rows": int(splits["train"][1].shape[0])}
    return results


def lookup_rank(rank: int, world: int, table: np.ndarray, ids: np.ndarray, g: np.ndarray,
                vocabs) -> Dict[str, Any]:
    """The sharded lookups on a (1, world) mesh: forward rows and this rank's
    block of the table gradient of sum(rows * g), both strategies; the blocks
    of ``shard_table`` for each vocabulary; the unshard round trip."""
    mesh = make_mesh(1, world)
    counts = Counts()
    full = torch.from_numpy(table)
    out: Dict[str, Any] = {}
    for name in ("psum", "scatter"):
        block = shard_table(full, mesh).requires_grad_(True)
        if name == "psum":
            rows = sharded_gather(block, torch.from_numpy(ids), mesh)
            (rows * torch.from_numpy(g)).sum().backward()
        else:
            per = len(ids) // world
            mine = slice(rank * per, (rank + 1) * per)
            rows = sharded_gather_scatter(block, torch.from_numpy(ids[mine]), mesh)
            (rows * torch.from_numpy(g[mine])).sum().backward()
        out[name] = {"rows": rows.detach().numpy(), "grad": block.grad.numpy(),
                     "calls": counts.take()}
    out["blocks"] = {v: shard_table(torch.arange(v * 3, dtype=torch.float32).reshape(v, 3),
                                    mesh).numpy() for v in vocabs}
    params = {"user": full, "tables.item": full[:7].clone(), "deep.0.w": full[:5, :2].clone()}
    sharded, cfg, heights = ep.shard_model_tables(params, mesh)
    back = ep.unshard_model_tables(sharded, heights, mesh)
    out["round_trip"] = all(torch.equal(back[k], params[k]) for k in params)
    out["heights"] = heights
    out["sharded_heights"] = sorted(cfg.sharded_heights)
    return out


def serving_rank(rank: int, world: int, cases: List[dict]) -> Dict[str, Any]:
    """``sharded_topk``, ``sharded_feature_topk`` and ``ShardedRecommender``
    on a (1, world) mesh; ``cases`` gives each its inputs."""
    from deeplearningrecommendationsystem_tpu_torch.serving import ShardedRecommender

    mesh = make_mesh(1, world)
    counts = Counts()
    out: Dict[str, Any] = {}
    for case in cases:
        seen = None if case.get("seen") is None else torch.from_numpy(case["seen"])
        users = case.get("users")
        if case["op"] == "topk":
            P, Q = torch.from_numpy(case["P"]), torch.from_numpy(case["Q"])
            vals, ids = pserving.sharded_topk(P, shard_table(Q, mesh), mesh, Q.shape[0],
                                              case["k"], seen=seen)
        else:
            model = build(case["kind"], case["U"], case["I"], case["kwargs"], case["params"])
            ctx = ServingContext(user_features=torch.from_numpy(case["user_features"]),
                                 item_features=torch.from_numpy(case["item_features"]))
            params, _, _ = ep.shard_model_tables(
                {k: v.detach() for k, v in model.named_parameters()}, mesh)
            if case["op"] == "feature_topk":
                vals, ids = pserving.sharded_feature_topk(model, params, ctx, mesh, case["k"],
                                                          seen=seen, users=users)
            else:
                rec = ShardedRecommender(model, params, ctx, mesh, seen=case.get("seen"),
                                         device="cpu")
                ids, vals = rec.top_k_with_scores(case["k"], users)
                out[case["name"] + ":score"] = rec.score(case["score_user"], case["score_items"])
        out[case["name"]] = {"ids": np_tree(ids), "vals": np_tree(vals), "calls": counts.take()}
    return out


def experiment_rank(rank: int, world: int, data_dir: str, cases: List[dict]) -> Dict[str, Any]:
    """``run_experiment`` of each case (a preset, its overrides, the JAX
    sampler's draws in order and the JAX init's params) on this world's mesh."""
    from deeplearningrecommendationsystem_tpu_torch import experiments
    from deeplearningrecommendationsystem_tpu_torch.configs.presets import PRESETS
    from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K

    out = {}
    for case in cases:
        draws = iter(case["draws"])

        class Draws:  # the JAX sampler's arrays, in the order it drew them
            def __init__(self, excluded, seed=0, device="cpu"):
                pass

            def sample(self, n):
                return next(draws)

        def init_model(cfg, data, generator=None, case=case):
            model = experiments._FEATURE_MODELS.get(cfg.model)
            model = (model(data.spec, **cfg.model_kwargs, device="cpu") if model is not None
                     else models.MatrixFactorization(data.num_users, data.num_items,
                                                     **cfg.model_kwargs, device="cpu"))
            return params_from_jax(model, case["params"])

        experiments.NegativeSampler, experiments.build_model = Draws, init_model
        cfg = PRESETS[case["preset"]].replace(**case["over"])
        res = experiments.run_experiment(cfg, data=MovieLens100K(data_dir, seed=0), device="cpu")
        out[case["name"]] = {"history": res.history, "extras": res.extras,
                             "params": np_tree(res.params), "ranking": res.ranking}
    return out


def modes_rank(rank: int, world: int, cases: List[dict]) -> Dict[str, Any]:
    """Sparse mode on a (1, world) mesh (lazy Adam and row-wise AdaGrad, the
    tables gathered back, and once left sharded) and stream mode on a
    (world, 1) mesh; with ``world`` 1, the same calls with no mesh (no
    process group needed)."""
    from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import data_sharding
    from deeplearningrecommendationsystem_tpu_torch.train import fit_minibatch_sparse, fit_stream

    ep_mesh = make_mesh(1, world) if world > 1 else None
    dp_mesh = make_mesh(world, 1) if world > 1 else None
    mf, fm = cases
    out = {}
    for run, case, optimizer, unshard in (("mf_lazy_adam", mf, "lazy_adam", True),
                                          ("mf_rowwise_adagrad", mf, "rowwise_adagrad", True),
                                          ("deepfm_lazy_adam", fm, "lazy_adam", True),
                                          ("mf_lazy_adam_sharded", mf, "lazy_adam", False)):
        model = build(case["kind"], case["U"], case["I"], case["kwargs"], case["params"])
        trainer = Trainer(model, TrainConfig(learning_rate=case["lr"], epochs=2), device="cpu")
        b, y = case["splits"]["train"]
        b = tuple(torch.from_numpy(a) for a in b) if isinstance(b, tuple) else torch.from_numpy(b)
        res = fit_minibatch_sparse(trainer, 0, (b, torch.from_numpy(y)), batch_size=40,
                                   optimizer=optimizer, mesh=ep_mesh, unshard=unshard)
        out[run] = {"train_loss": np_tree(res.history["train_loss"]),
                    "params": np_tree(res.params), "ep_heights": res.ep_heights}
    model = build("mf", mf["U"], mf["I"], mf["kwargs"], mf["params"])
    trainer = Trainer(model, TrainConfig(learning_rate=mf["lr"], epochs=2, mesh=dp_mesh),
                      device="cpu")
    res = fit_stream(trainer, 0, mf["splits"]["train"], batch_size=40, seed=3,
                     sharding=None if dp_mesh is None else data_sharding(dp_mesh))
    out["mf_stream"] = {"train_loss": np_tree(res.history["train_loss"]),
                        "params": np_tree(res.params)}
    return out


def sleeping_rank(rank: int, world: int, seconds: float) -> None:
    """A rank that outlives any deadline shorter than ``seconds``."""
    import time

    time.sleep(seconds)


def serve_rank(rank: int, world: int, data_dir: str) -> Any:
    """``cli/serve.py`` under ``--mesh 1,world``: rank 0 answers requests
    through the server's routing (each broadcast to the workers) and stops
    them; the other ranks run the worker loop and return its call count."""
    from deeplearningrecommendationsystem_tpu_torch.cli import serve
    from deeplearningrecommendationsystem_tpu_torch.server import RecommenderServer

    args = serve.parser().parse_args(["--model", "mf", "--data", data_dir, "--epochs", "2",
                                      "--device", "cpu", "--backend", "gloo",
                                      "--mesh", f"1,{world}"])
    rec = serve.build_recommender(args)
    if rank:
        return serve.worker_loop(rec)
    server = RecommenderServer(rec)
    try:
        answers = [server.dispatch("GET", "/v1/recommend?user=3&k=5", None),
                   server.dispatch("POST", "/v1/recommend", {"users": [0, 7], "k": 4}),
                   server.dispatch("POST", "/v1/score", {"user": 2, "items": [0, 5, 9]})]
    finally:
        rec.stop()
        server.httpd.server_close()
    return answers
