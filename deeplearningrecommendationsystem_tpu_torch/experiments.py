"""End-to-end experiment runner: one function per reference entry script.

The JAX package's ``experiments.py`` on PyTorch, for the presets ported so
far: load ml-100k -> sample per-split negatives -> build full-batch tensors ->
train N epochs with per-epoch train/valid/test metrics -> score the full
catalog -> ranking@k on valid and test with seen items excluded.

Ported, full-batch: the 'pair' family for MF (the pattern of scripts/mf.py),
the 'feature' family for LR, AFM, DeepFM, WideDeep, NFM, PNN, DCN (the
``deepcross`` preset), DeepCrossing and FFM (the pattern of scripts/lr.py:
each split's [N, 45] feature matrix) and the 'seq' family for DIN (the pattern of
scripts/din.py: each split's (history window [N, L], target [N]), the window
taken from that split's own positives). The other presets, families and
training modes raise ``NotImplementedError`` naming their ``ROADMAP.md`` item.

The initial weights and the negatives are drawn from CPU generators seeded
from ``cfg.seed`` and then moved to ``device``, so a run on a card and the
same run on the CPU start from the same numbers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.configs.presets import ExperimentConfig
from deeplearningrecommendationsystem_tpu_torch.data.movielens import MovieLens100K, Split
from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.eval.ranking import ranking_metrics
from deeplearningrecommendationsystem_tpu_torch.eval.recommend import score_ranking, seen_to_tail
from deeplearningrecommendationsystem_tpu_torch.models import (
    AFM,
    DCN,
    DIN,
    FFM,
    NFM,
    PNN,
    DeepCrossing,
    DeepFM,
    LogisticRegression,
    MatrixFactorization,
    ServingContext,
    WideDeep,
)
from deeplearningrecommendationsystem_tpu_torch.sampling import NegativeSampler
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer

# ROADMAP.md §1 items that bring the presets not ported yet
_NOT_PORTED = {
    "neuralcf": "item 9", "autorec": "item 9", "i-autorec": "item 9",
    "dien": "item 10",
}
# the feature family's models over the spec, by preset name
_FEATURE_MODELS = {"lr": LogisticRegression, "afm": AFM, "deepfm": DeepFM, "widedeep": WideDeep,
                   "nfm": NFM, "pnn": PNN, "deepcross": DCN, "deepcrossing": DeepCrossing,
                   "ffm": FFM}
FAMILIES = ("pair", "feature", "seq")


def build_model(cfg: ExperimentConfig, data: MovieLens100K,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The preset's model on the CPU, its weights drawn from ``generator``
    (a CPU generator; seeded from ``cfg.seed`` when None)."""
    if cfg.model not in ("mf", "din") and cfg.model not in _FEATURE_MODELS:
        where = _NOT_PORTED.get(cfg.model, "§1")
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet; see ROADMAP.md §1 {where}")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    kw = dict(cfg.model_kwargs, generator=generator, device="cpu")
    if cfg.model == "mf":
        return MatrixFactorization(data.num_users, data.num_items, **kw)
    if cfg.model == "din":
        return DIN(data.num_items, **kw)
    return _FEATURE_MODELS[cfg.model](data.spec, **kw)


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

    @property
    def examples_per_sec(self) -> float:
        return self.train_examples * self.epochs / max(self.train_time_s, 1e-9)

    def final_metrics(self) -> Dict[str, float]:
        out = {k: float(v[-1]) for k, v in self.history.items() if not k.startswith("_")}
        out.update(self.extras)
        return out


def _check_supported(cfg: ExperimentConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; see ROADMAP.md §1 items 9-10")
    if cfg.train_mode != "fullbatch":
        raise NotImplementedError(
            f"train_mode {cfg.train_mode!r} is not ported yet; see ROADMAP.md §1 item 11")
    if cfg.mesh_shape is not None:
        raise NotImplementedError("mesh_shape (DP/EP) is not ported yet; see ROADMAP.md §1 item 13")
    if cfg.aux_weight > 0:
        raise NotImplementedError("aux_weight is DIEN's; see ROADMAP.md §1 item 10")


def split_batches(cfg: ExperimentConfig, data: MovieLens100K,
                  device: str | torch.device = "cuda") -> Dict[str, Tuple[Any, torch.Tensor]]:
    """{"train", "valid", "test"} -> (batch, labels) on ``device``: each split's
    positives with ``cfg.negatives`` sampled negatives per user, drawn in that
    order from one sampler seeded from ``cfg.seed``. The batch is (users,
    items) for the pair family, the [N, 45] feature matrix for the feature
    family and (history [N, hist_len], items) for the seq family, each row's
    history the user's window over that split's positives
    (``history_matrix``)."""
    dev = resolve_device(device)
    sampler = NegativeSampler(data.seen_mask(data.train, data.valid, data.test),
                              seed=cfg.seed, device=dev)
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
        else:
            batch = (torch.from_numpy(combined["user"]).to(dev),
                     torch.from_numpy(combined["item"]).to(dev))
        batches[name] = (batch, torch.from_numpy(combined["rating"]).to(dev))
    return batches


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_experiment(
    cfg: ExperimentConfig,
    data: Optional[MovieLens100K] = None,
    data_path: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> ExperimentResult:
    """Train and evaluate ``cfg`` on ``data`` (or the ml-100k files under
    ``data_path``) on ``device``."""
    dev = resolve_device(device)
    _check_supported(cfg)
    if data is None:
        if data_path is None:
            raise ValueError("pass data or data_path (a directory in ml-100k format)")
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
        ),
        device=dev,
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

    batches = split_batches(cfg, data, dev)
    train_examples = len(batches["train"][1])

    # ---- train (full batch, one Adam step per epoch) ----
    _sync(dev)
    t0 = time.perf_counter()
    result = trainer.fit(batches["train"], valid=batches["valid"], test=batches["test"])
    _sync(dev)
    train_time = time.perf_counter() - t0

    # ---- serving + ranking eval ----
    with torch.no_grad():
        scores = model.score_catalog(ctx)
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

    return ExperimentResult(
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
