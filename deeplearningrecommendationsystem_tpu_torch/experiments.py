"""End-to-end experiment runner: one function per reference entry script.

The JAX package's ``experiments.py`` on PyTorch, for every preset: load
ml-100k -> sample negatives -> build full-batch tensors -> train N epochs with
per-epoch train/valid/test metrics -> score the full catalog -> ranking@k on
valid and test.

Families, full-batch: 'pair' (MF, NeuralCF; the pattern of scripts/mf.py:
(users, items)); 'feature' (LR, AFM, DeepFM, WideDeep, NFM, PNN, DCN as the
``deepcross`` preset, DeepCrossing, FFM; the pattern of scripts/lr.py: each
split's [N, 45] feature matrix); 'seq' (DIN, DIEN; the pattern of
scripts/din.py: each split's (history window [N, L], target [N]), the window
taken from that split's own positives; DIEN's ``aux_weight`` appends each
example's per-step negatives [N, L]); 'matrix' (AutoRec, I-AutoRec; the
pattern of scripts/autorec.py: global negatives drawn before a 60/20/20 split
of the rating matrix's rows, the loss over rated entries only, and a ranking
eval with no seen items filtered).

Training modes (``cfg.train_mode``): 'fullbatch', the reference's one Adam
step an epoch; 'minibatch' and 'stream', shuffled minibatch Adam with the
data on the device or streamed from host memory (``train/minibatch.py``; not
the matrix family); 'sparse', minibatch with row-sparse table updates
(``train/sparse_trainer.py``; models with the sparse-row protocol, MF and
DeepFM). The minibatch modes keep only ``history["train_loss"]``; the serving
and ranking evaluation follow every mode.

``cfg.mesh_shape`` ``(d, m)`` lays a mesh over the ranks of the process group
(``runtime/distributed.py::initialize``, or ``torchrun``), every rank calling
``run_experiment`` with the same config and data: in 'fullbatch' mode each
split is padded and cut into this rank's rows (``parallel/data.py``), and the
Trainer shards the tables over the model axis; 'stream' streams each rank
its slice of every batch (the data axis); 'sparse' row-shards the tables and
keeps the batches whole on every rank, as the JAX package does; 'minibatch'
runs the same batches on every rank. Every rank returns the same result.
With ``cfg.unshard_params=False`` the tables stay row-sharded and the ranking
evaluation is skipped (``serving.py::ShardedRecommender`` serves them).

The initial weights and the negatives are drawn from CPU generators seeded
from ``cfg.seed`` and then moved to ``device``, so a run on a card and the
same run on the CPU start from the same numbers; the row split and DIEN's
auxiliary negatives are the JAX package's NumPy draws.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.configs.presets import ExperimentConfig
from deeplearningrecommendationsystem_tpu_torch.data.movielens import MovieLens100K, Split
from deeplearningrecommendationsystem_tpu_torch.data.stream import tree_map
from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.eval.ranking import ranking_metrics
from deeplearningrecommendationsystem_tpu_torch.eval.recommend import (
    full_ranking,
    score_ranking,
    seen_to_tail,
)
from deeplearningrecommendationsystem_tpu_torch.models import (
    AFM,
    DCN,
    DIEN,
    DIN,
    FFM,
    NFM,
    PNN,
    AutoRec,
    DeepCrossing,
    DeepFM,
    LogisticRegression,
    MatrixFactorization,
    NeuralCF,
    ServingContext,
    WideDeep,
)
from deeplearningrecommendationsystem_tpu_torch.parallel import make_mesh, pad_and_shard
from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import data_sharding, mesh_shape
from deeplearningrecommendationsystem_tpu_torch.runtime.distributed import is_primary
from deeplearningrecommendationsystem_tpu_torch.sampling import NegativeSampler
from deeplearningrecommendationsystem_tpu_torch.train import (
    TrainConfig,
    Trainer,
    fit_minibatch,
    fit_minibatch_sparse,
    fit_stream,
)

# ml-100k in the reference checkout's layout, or the directory ML100K_PATH names
DEFAULT_DATA = os.environ.get("ML100K_PATH", "dataset_example/ml-100k")
# ROADMAP.md §1 items that bring the presets not ported yet: none is left
_NOT_PORTED: Dict[str, str] = {}
# the feature family's models over the spec, by preset name
_FEATURE_MODELS = {"lr": LogisticRegression, "afm": AFM, "deepfm": DeepFM, "widedeep": WideDeep,
                   "nfm": NFM, "pnn": PNN, "deepcross": DCN, "deepcrossing": DeepCrossing,
                   "ffm": FFM}
FAMILIES = ("pair", "feature", "seq", "matrix")
TRAIN_MODES = ("fullbatch", "minibatch", "stream", "sparse")


def build_model(cfg: ExperimentConfig, data: MovieLens100K,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The preset's model on the CPU, its weights drawn from ``generator``
    (a CPU generator; seeded from ``cfg.seed`` when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    kw = dict(cfg.model_kwargs, generator=generator, device="cpu")
    U, I = data.num_users, data.num_items
    if cfg.model in _FEATURE_MODELS:
        return _FEATURE_MODELS[cfg.model](data.spec, **kw)
    registry = {
        "mf": lambda: MatrixFactorization(U, I, **kw),
        "neuralcf": lambda: NeuralCF(U, I, **kw),
        "autorec": lambda: AutoRec(num_input=I, **kw),
        "i-autorec": lambda: AutoRec(num_input=U, **kw),
        "din": lambda: DIN(I, **kw),
        "dien": lambda: DIEN(I, **kw),
    }
    if cfg.model not in registry:
        raise ValueError(f"unknown model {cfg.model!r}")
    return registry[cfg.model]()


@dataclasses.dataclass
class ExperimentResult:
    model: str
    params: Dict[str, torch.Tensor]
    history: Dict[str, np.ndarray]
    ranking: Dict[str, Dict[str, float]]
    train_examples: int
    epochs: int
    train_time_s: float
    extras: Dict[str, float] = dataclasses.field(default_factory=dict)
    ctx: Any = None  # ServingContext used for the ranking eval (serving reuse)
    # name -> vocabulary of each table left row-sharded (unshard_params=False)
    ep_heights: Optional[Dict[str, int]] = None

    @property
    def examples_per_sec(self) -> float:
        return self.train_examples * self.epochs / max(self.train_time_s, 1e-9)

    def final_metrics(self) -> Dict[str, float]:
        out = {k: float(v[-1]) for k, v in self.history.items() if not k.startswith("_")}
        out.update(self.extras)
        return out


def _check_supported(cfg: ExperimentConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.train_mode not in TRAIN_MODES:
        raise ValueError(f"unknown train_mode {cfg.train_mode!r}")
    if cfg.family == "matrix" and cfg.train_mode in ("minibatch", "stream"):
        raise ValueError(f"{cfg.train_mode} mode: masked-matrix family N/A")
    if cfg.aux_weight > 0 and cfg.model != "dien":
        raise ValueError("aux_weight is the DIEN auxiliary-loss hook")


def split_batches(cfg: ExperimentConfig, data: MovieLens100K,
                  device: str | torch.device = "cuda") -> Dict[str, Tuple[Any, torch.Tensor]]:
    """{"train", "valid", "test"} -> (batch, labels) on ``device``: each split's
    positives with ``cfg.negatives`` sampled negatives per user, drawn in that
    order from one sampler seeded from ``cfg.seed``. The batch is (users,
    items) for the pair family, the [N, 45] feature matrix for the feature
    family and (history [N, hist_len], items) for the seq family, each row's
    history the user's window over that split's positives
    (``history_matrix``). Under ``cfg.aux_weight`` the seq family's train
    batch also carries ``aux_negatives``. The matrix family takes
    ``matrix_batches``."""
    dev = resolve_device(device)
    excluded = data.seen_mask(data.train, data.valid, data.test)
    sampler = NegativeSampler(excluded, seed=cfg.seed, device=dev)
    batches = {}
    for name, split, n_neg in (
        ("train", data.train, cfg.negatives[0]),
        ("valid", data.valid, cfg.negatives[1]),
        ("test", data.test, cfg.negatives[2]),
    ):
        combined: Split = MovieLens100K.concat_splits(split, sampler.sample(n_neg))
        if cfg.family == "feature":
            batch = torch.from_numpy(data.feature_matrix(combined)).to(dev)
        elif cfg.family == "seq":
            hist = data.history_matrix(split, cfg.hist_len)[combined["user"]]
            batch = (torch.from_numpy(hist).to(dev), torch.from_numpy(combined["item"]).to(dev))
            if name == "train" and cfg.aux_weight > 0:
                neg = aux_negatives(cfg, data, combined["user"], excluded)
                batch = batch + (torch.from_numpy(neg).to(dev),)
        else:
            batch = (torch.from_numpy(combined["user"]).to(dev),
                     torch.from_numpy(combined["item"]).to(dev))
        batches[name] = (batch, torch.from_numpy(combined["rating"]).to(dev))
    return batches


def aux_negatives(cfg: ExperimentConfig, data: MovieLens100K, users: np.ndarray,
                  excluded: np.ndarray) -> np.ndarray:
    """DIEN's auxiliary-loss negatives [N, hist_len] int64: per example,
    items drawn uniformly from ``default_rng(cfg.seed + 17)`` and drawn again,
    up to four rounds, where they collide with the user's ``excluded`` items
    (the JAX package's draws, number for number)."""
    users = np.asarray(users)
    rng = np.random.default_rng(cfg.seed + 17)
    neg = rng.integers(0, data.num_items, (len(users), cfg.hist_len))
    for _ in range(4):
        bad = excluded[users[:, None], neg]
        if not bad.any():
            break
        neg = np.where(bad, rng.integers(0, data.num_items, neg.shape), neg)
    return neg


def split_rows_60_20_20(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train, valid, test) row indices, the reference's two-stage split
    (scripts/autorec.py:34-35): 20% test, then a quarter of the rest valid,
    from ``np.random.default_rng(seed).permutation(n)``."""
    perm = np.random.default_rng(seed).permutation(n)
    n_test = int(n * 0.2)
    test, rest = perm[:n_test], perm[n_test:]
    n_valid = int(len(rest) * 0.25)
    return rest[n_valid:], rest[:n_valid], test


def matrix_batches(cfg: ExperimentConfig, data: MovieLens100K,
                   device: str | torch.device = "cuda"):
    """The matrix family's splits: ``cfg.global_negatives`` negatives a user
    drawn before any split (scripts/autorec.py:24-27) into the rating matrix
    (1 rated, 0 a negative, 0.5 neither; [I, U] under ``cfg.item_major``),
    whose rows are split 60/20/20. Returns ({split: (rows, rows)}, {split:
    weights, 1 where an entry is not 0.5}, the matrix, (train, valid, test)
    row indices), on ``device``."""
    dev = resolve_device(device)
    sampler = NegativeSampler(data.seen_mask(data.data), seed=cfg.seed, device=dev)
    matrix = data.rating_matrix(sampler.sample(cfg.global_negatives), item_major=cfg.item_major)
    rows = split_rows_60_20_20(matrix.shape[0], cfg.seed)
    m = torch.from_numpy(matrix).to(dev)
    batches, weights = {}, {}
    for name, idx in zip(("train", "valid", "test"), rows):
        x = m[torch.from_numpy(idx).to(dev)]
        batches[name] = (x, x)
        weights[name] = (x != 0.5).float()
    return batches, weights, m, rows


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_experiment(
    cfg: ExperimentConfig,
    data: Optional[MovieLens100K] = None,
    data_path: str = DEFAULT_DATA,
    device: str | torch.device = "cuda",
    verbose: bool = False,
) -> ExperimentResult:
    """Train and evaluate ``cfg`` on ``data`` (or the ml-100k files under
    ``data_path``) on ``device``; ``verbose`` prints the reference-format
    report (``runtime/logging.py::print_report``)."""
    dev = resolve_device(device)
    _check_supported(cfg)
    mesh = None
    if cfg.mesh_shape is not None:
        mesh = make_mesh(data=cfg.mesh_shape[0], model=cfg.mesh_shape[1])
    if data is None:
        data = MovieLens100K(data_path, seed=cfg.seed)
    model = build_model(cfg, data).to(dev)
    trainer = Trainer(
        model,
        TrainConfig(
            learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay,
            epochs=cfg.epochs,
            track_metrics=cfg.track_metrics,
            compute_dtype=cfg.compute_dtype,
            matmul_gather_bwd=cfg.matmul_gather_bwd,
            onehot_gather=cfg.onehot_gather,
            mesh=mesh,
            ep_strategy=cfg.ep_strategy,
            unshard_params=cfg.unshard_params,
        ),
        device=dev,
        # the fused path: logits and the auxiliary loss in one forward
        aux_loss_fn="model" if cfg.aux_weight > 0 else None,
        aux_weight=cfg.aux_weight,
    )
    ctx = ServingContext(
        user_features=torch.from_numpy(data.user_features).to(dev),
        item_features=torch.from_numpy(data.item_features).to(dev),
    )
    if cfg.family == "seq":
        ctx.history = torch.from_numpy(data.history_matrix(data.data, cfg.hist_len)).to(dev)
        if cfg.full_history_serving:
            # the reference scores each user's COMPLETE history
            # (scripts/din.py:99-100 -> model/din.py:55-66)
            ctx.full_histories = [row[row >= 0] for row in data.itemid_matrix(data.data)]

    weights = None
    if cfg.family == "matrix":
        batches, weights, ctx.rating_matrix, rows = matrix_batches(cfg, data, dev)
        train_examples = int(weights["train"].sum())
    else:
        batches = split_batches(cfg, data, dev)
        train_examples = len(batches["train"][1])

    if mesh is not None and cfg.train_mode == "fullbatch" and _cuts_batch(cfg, mesh):
        # DP: pad each split to the block count, zero-weight the pad rows and
        # keep this rank's block
        sharded = {}
        for name, (b, y) in batches.items():
            b, y, sharded[name] = pad_and_shard(b, y, mesh, (weights or {}).get(name),
                                                cfg.ep_strategy)
            batches[name] = (b, y)
        weights = sharded

    # ---- train ----
    _sync(dev)
    t0 = time.perf_counter()
    result = _train(cfg, trainer, batches, weights, mesh)
    _sync(dev)
    train_time = time.perf_counter() - t0

    if result.ep_heights:
        # tables left row-sharded (unshard_params=False): the dense catalog
        # scorer cannot run -- serve through ShardedRecommender; the ranking
        # evaluation is skipped by design
        return ExperimentResult(
            model=cfg.model, params=result.params,
            history={k: v.cpu().numpy() for k, v in result.history.items()}, ranking={},
            train_examples=train_examples, epochs=cfg.epochs, train_time_s=train_time,
            extras=result.extras, ctx=ctx, ep_heights=result.ep_heights)

    # ---- serving + ranking eval ----
    with torch.no_grad():
        scores = model.score_catalog(ctx)
    if cfg.family == "matrix":
        ranking = _matrix_ranking(cfg, data, scores, rows)
    else:
        ranking = _split_ranking(cfg, data, scores)

    out = ExperimentResult(
        model=cfg.model,
        params=result.params,
        history={k: v.cpu().numpy() for k, v in result.history.items()},
        ranking=ranking,
        train_examples=train_examples,
        epochs=cfg.epochs,
        train_time_s=train_time,
        extras=result.extras,
        ctx=ctx,
    )
    if verbose and is_primary():
        from deeplearningrecommendationsystem_tpu_torch.runtime.logging import print_report

        print_report(out, k=cfg.k)
    return out


def _cuts_batch(cfg: ExperimentConfig, mesh) -> bool:
    """Whether the full batch is cut over more than one rank: the data axis,
    or every rank under the ``scatter`` lookup into sharded tables."""
    shape = mesh_shape(mesh)
    return shape["data"] > 1 or (cfg.ep_strategy == "scatter" and shape["model"] > 1)


def _train(cfg: ExperimentConfig, trainer: Trainer, batches, weights, mesh=None):
    """Train in ``cfg.train_mode``: 'fullbatch' (one Adam step an epoch),
    'minibatch' and 'stream' (shuffled minibatch Adam, the data on the device
    or streamed from host memory), 'sparse' (minibatch with row-sparse table
    updates). Each minibatch mode draws its order from ``cfg.seed``."""
    if cfg.train_mode == "fullbatch":
        return trainer.fit(batches["train"], valid=batches["valid"], test=batches["test"],
                           weights=weights)
    if cfg.train_mode == "minibatch":
        return fit_minibatch(trainer, cfg.seed, batches["train"], batch_size=cfg.batch_size)
    if cfg.train_mode == "stream":
        # the dataset stays in HOST memory; StreamingLoader shuffles + prefetches
        b, y = batches["train"]
        host_train = (tree_map(lambda t: t.cpu().numpy(), b), y.cpu().numpy())
        sharding = None if mesh is None else data_sharding(mesh)
        return fit_stream(trainer, cfg.seed, host_train, batch_size=cfg.batch_size,
                          sharding=sharding, seed=cfg.seed)
    if cfg.train_mode == "sparse":
        return fit_minibatch_sparse(trainer, cfg.seed, batches["train"],
                                    batch_size=cfg.batch_size, optimizer=cfg.sparse_optimizer,
                                    mesh=mesh, ep_strategy=cfg.ep_strategy,
                                    unshard=cfg.unshard_params)
    raise ValueError(cfg.train_mode)


def _matrix_ranking(cfg: ExperimentConfig, data: MovieLens100K, scores: torch.Tensor,
                    rows) -> Dict[str, Dict[str, float]]:
    """Ranking@k on the valid and test rows with no seen item filtered, the
    actual lists every interaction of the user (scripts/autorec.py:64-78).
    I-AutoRec trains on item rows but is ranked by user: the 943 user rows are
    split again with the same seed (scripts/i-autorec.py:61-70)."""
    dev = scores.device
    actual_all = data.itemid_matrix(data.data)
    rec = full_ranking(scores, torch.zeros(scores.shape, dtype=torch.bool, device=dev))
    if cfg.item_major:
        _, va, te = split_rows_60_20_20(data.num_users, cfg.seed)
    else:
        _, va, te = rows
    ranking: Dict[str, Dict[str, float]] = {}
    for name, idx in (("valid", va), ("test", te)):
        actual = torch.from_numpy(actual_all[idx]).to(dev)
        for k_cut, suffix in ((cfg.k, ""), (10, "@10")):
            m = ranking_metrics(actual, rec[torch.from_numpy(idx).to(dev)], k_cut)
            ranking[name + suffix] = {k_: float(v) for k_, v in m.items()}
    return ranking


def _split_ranking(cfg: ExperimentConfig, data: MovieLens100K,
                   scores: torch.Tensor) -> Dict[str, Dict[str, float]]:
    """Ranking@k on valid and test with the other splits' items excluded."""
    dev = scores.device
    reals = {name: data.itemid_matrix(getattr(data, name)) for name in ("train", "valid", "test")}
    counts = {name: (reals[name] >= 0).sum(1) for name in reals}
    # one float sort of the catalog scores; per-split lists are stable
    # boolean partitions of it (eval/recommend.py::seen_to_tail)
    rec_all = score_ranking(scores)
    ranking: Dict[str, Dict[str, float]] = {}
    for name, others in (("valid", ("train", "test")), ("test", ("train", "valid"))):
        seen = torch.from_numpy(data.seen_mask(*(getattr(data, o) for o in others))).to(dev)
        rec = seen_to_tail(rec_all, seen)
        n_seen = torch.from_numpy(counts[others[0]] + counts[others[1]]).to(dev)
        actual = torch.from_numpy(reals[name]).to(dev)
        for k_cut, suffix in ((cfg.k, ""), (10, "@10")):
            m = ranking_metrics(actual, rec, k_cut, n_seen=n_seen)
            ranking[name + suffix] = {k_: float(v) for k_, v in m.items()}
    return ranking
