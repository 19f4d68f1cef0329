"""Full-batch trainer: one Adam step per epoch over the whole training set.

The JAX package's ``train/trainer.py`` on PyTorch. The reference trains
full-batch, evaluating train/valid/test pointwise metrics every epoch
(trainer/trainer.py:23-146). The JAX trainer compiles the whole run into one
``lax.scan``; here it is a Python loop over epochs whose metrics stay on the
device as 0-d tensors, stacked into [epochs] histories at the end: no epoch
waits for the device.

Semantics kept from the JAX trainer:
* train metrics come from the PRE-update forward of the epoch (the reference
  reuses ``predictions_train`` computed before ``optimizer.step()``);
* valid/test metrics come from the post-update params, in float32;
* the loss is BCE-with-logits; with a weight mask it is
  ``sum(l * w) / max(sum(w), 1)`` (the reference's ``train_loop2``);
* ``compute_dtype``: float params are cast to it for the forward and
  backward, the master weights stay float32 and the loss is float32; the
  batch stays as given (the JAX trainer casts it as well, which rounds a
  [B, 45] feature matrix's ids above 256), and a model casts each float
  block of its batch to the dtype of the weight it meets;
* ``extras[f"{split}_auc_raw"]`` is the true AUC on the final params;
* ``history["_param_checksum"]`` ([1]) sums every final param and Adam
  moment (not Adam's step count);
* ``aux_loss_fn`` adds an auxiliary term, ``loss = bce + aux_weight * aux``
  with ``aux`` in float32 (the JAX trainer's composite-loss hook, DIEN's
  auxiliary loss): ``"model"`` takes the model's ``apply_with_aux(params,
  batch) -> (logits, aux)``, one forward for both; a callable
  ``aux_loss_fn(params, batch) -> scalar`` is evaluated beside the forward
  on the uncast params. The train metrics keep the logits of the loss; valid
  and test take ``apply_params``.

The model holds its parameters (an ``nn.Module`` with ``apply_params``); ``fit``
trains them in place. The JAX ``rng`` argument is gone: the model draws its
initial weights when it is built. ``fit(params=..., opt_state=...)`` resumes
from a ``TrainResult``'s ``params`` and ``opt_state`` (or from the JAX
package's, through ``weights.py``).

A ``mesh`` (``parallel/mesh.py::make_mesh``; one process per rank, every
rank calling ``fit`` with its own rows of each split, as
``parallel/data.py::pad_and_shard`` cuts them) trains data-parallel over its
'data' axis and, where its 'model' axis is larger than 1, with the user/item
tables row-sharded over that axis (EP, ``parallel/ep.py``): ``fit`` replaces
each table by this rank's row block, and every lookup into it runs the
``ep_strategy`` collective (``psum`` or ``scatter``). After the backward each
gradient is summed over the right group: a table block's over the data
group; a replicated parameter's over the data group under ``psum`` (each
model rank of a data group holds the same rows) and over every rank under
``scatter`` (each model rank holds other rows). The loss stays the JAX
trainer's ``sum(w * l) / max(sum(w), 1)`` over the global batch, the global
``sum(w)`` summed once a split, and the metrics (AUC included) are taken on
the gathered global predictions. Every rank runs the same Adam on the same
summed gradients, so the replicated parameters stay replicated, bit for bit;
``history["_param_checksum"]`` sums the whole tables, so it is the same on
every rank. ``unshard_params`` (default) gathers the tables back whole and
unpadded at the end; ``unshard_params=False`` leaves the blocks in the model
and in ``TrainResult.params`` for ``serving.py::ShardedRecommender``, with
``TrainResult.ep_heights`` the tables' vocabularies. A group of one rank runs
no collective: a ``(1, 1)`` mesh gives the run without one, bit for bit.

The JAX config's gather-route flags (``matmul_gather_bwd``, ``pallas_gather``,
``onehot_gather``) are accepted and have no effect: they chose among TPU
routes for the id lookup, and every route is the same kernel pair here (the
gather and ``onehot_grad`` of ``ops/embedding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.eval.pointwise import pointwise_metrics, true_auc
from deeplearningrecommendationsystem_tpu_torch.parallel import collectives
from deeplearningrecommendationsystem_tpu_torch.parallel.ep import (
    STRATEGIES,
    EmbeddingPartitioning,
    embedding_partitioning,
    set_parameters,
    shard_model_tables,
    unshard_table,
)
from deeplearningrecommendationsystem_tpu_torch.parallel.embedding import shard_table
from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_size,
)
from deeplearningrecommendationsystem_tpu_torch.runtime.profiler import span
from deeplearningrecommendationsystem_tpu_torch.train.optim import torch_adam

Batch = Any  # model-specific: (users, items) for the pair family
OptState = Dict[str, Dict[str, torch.Tensor]]  # param name -> Adam state


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    epochs: int = 100
    track_metrics: bool = True  # per-epoch train/valid/test metrics (parity mode)
    # mixed precision: float params cast to this dtype for the forward and
    # backward (f32 master weights, f32 loss). None = pure f32 (parity mode).
    compute_dtype: Optional[str] = None
    # a ('data', 'model') DeviceMesh: DP over 'data', the user/item tables
    # row-sharded over 'model' (EP) where it is larger than 1. None = one rank.
    mesh: Any = None
    ep_strategy: str = "psum"  # 'psum' | 'scatter' (parallel/ep.py)
    # False = leave the tables row-sharded (vocab-padded) after fit for
    # serving.py::ShardedRecommender; TrainResult.ep_heights then holds their
    # vocabularies.
    unshard_params: bool = True
    # the JAX gather routes, accepted with no effect (one kernel pair here)
    matmul_gather_bwd: bool = False
    pallas_gather: bool = False
    onehot_gather: bool = False


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]  # name -> final tensor (detached copy)
    history: Dict[str, torch.Tensor]  # each entry [epochs], on the device
    extras: Dict[str, float] = dataclasses.field(default_factory=dict)
    opt_state: Optional[OptState] = None  # for resume
    # name -> vocabulary of each table left row-sharded (unshard_params=False)
    ep_heights: Optional[Dict[str, int]] = None

    def last(self) -> Dict[str, float]:
        out = {k: float(v[-1]) for k, v in self.history.items() if not k.startswith("_")}
        out.update(self.extras)
        return out


def _bce_with_logits(logits, labels, weights=None, denom=None):
    """The weighted mean BCE; with ``denom`` (the global ``max(sum(w), 1)`` of
    a data-parallel batch) this rank's part of it, ``sum(w * l) / denom``."""
    losses = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
    if denom is not None:
        return torch.sum(losses if weights is None else losses * weights.to(losses.dtype)) / denom
    if weights is None:
        return losses.mean()
    w = weights.to(losses.dtype)
    return torch.sum(losses * w) / torch.clamp(torch.sum(w), min=1.0)


def _cast_floats(tree, dtype):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_floats(x, dtype) for x in tree)
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _to_device(tree, device):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(x, device) for x in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class Trainer:
    """Drives a model's full-batch training on ``device``."""

    def __init__(self, model: nn.Module, config: TrainConfig, device: str | torch.device = "cuda",
                 aux_loss_fn=None, aux_weight: float = 1.0):
        if config.mesh is not None and not isinstance(config.mesh, DeviceMesh):
            raise TypeError(f"mesh: a parallel/mesh.py::make_mesh DeviceMesh, got "
                            f"{type(config.mesh).__name__}")
        if config.ep_strategy not in STRATEGIES:
            raise ValueError(f"ep_strategy {config.ep_strategy!r}: one of {STRATEGIES}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.optimizer = torch_adam(self.model.parameters(), config.learning_rate,
                                    config.weight_decay)
        self.fused_aux = isinstance(aux_loss_fn, str)
        if self.fused_aux and aux_loss_fn != "model":
            raise ValueError(f"aux_loss_fn {aux_loss_fn!r}: 'model', a callable or None")
        self.aux_loss_fn = None if self.fused_aux else aux_loss_fn
        self.aux_weight = aux_weight
        # the EP policy while the model holds row blocks of its tables, and
        # the tables' vocabularies by parameter name
        self.ep: Optional[EmbeddingPartitioning] = None
        self.ep_table_heights: Dict[str, int] = {}

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    # -- the parallel layer -------------------------------------------------
    def batch_group(self):
        """The ranks a data-parallel batch is cut over: the data group, or
        every rank under the ``scatter`` lookup into sharded tables; None
        without a mesh."""
        mesh = self.config.mesh
        if mesh is None:
            return None
        if self.ep is not None and self.ep.strategy == "scatter":
            return collectives.world_group()
        return axis_group(mesh, DATA_AXIS)

    def _replace_params(self, new: Dict[str, torch.Tensor], moment) -> None:
        """Replace the parameters named in ``new`` (a block for a table, or
        back) and rebuild the optimizer, each replaced parameter's Adam
        moments mapped by ``moment(name, tensor)``."""
        old_state = {n: self.optimizer.state.get(p) for n, p in self._params().items()}
        set_parameters(self.model, new)
        self.optimizer = torch_adam(self.model.parameters(), self.config.learning_rate,
                                    self.config.weight_decay)
        for name, p in self._params().items():
            st = old_state.get(name)
            if st:
                self.optimizer.state[p] = {
                    k: moment(name, v) if name in new and v.dim() else v for k, v in st.items()}

    def _shard_tables(self) -> None:
        mesh = self.config.mesh
        blocks, self.ep, self.ep_table_heights = shard_model_tables(
            self._params(), mesh, self.config.ep_strategy)
        self._replace_params({n: blocks[n] for n in self.ep_table_heights},
                             lambda n, v: shard_table(v, mesh))

    def _unshard_tables(self) -> None:
        mesh, heights = self.config.mesh, self.ep_table_heights
        full = lambda n, v: unshard_table(v, heights[n], mesh)  # noqa: E731
        named = self._params()
        self._replace_params({n: full(n, named[n]) for n in heights}, full)
        self.ep, self.ep_table_heights = None, {}

    def _sum_grads(self) -> None:
        """Sum every gradient over its group: a table block's over the data
        group, any other over the batch group."""
        tables, rest = [], []
        for name, p in self._params().items():
            if p.grad is not None:
                (tables if name in self.ep_table_heights else rest).append(p.grad)
        collectives.sum_tensors_(tables, axis_group(self.config.mesh, DATA_AXIS))
        collectives.sum_tensors_(rest, self.batch_group())

    # -- single step ------------------------------------------------------
    def loss_fn(self, params: Dict[str, torch.Tensor], batch: Batch, labels, weights=None,
                denom=None):
        """(loss, logits): both float32, under the ``compute_dtype`` policy;
        with ``denom`` the loss is this rank's part of a data-parallel one.
        There the auxiliary term, a mean over this rank's block, is divided
        by the batch group's size: every rank holds an equal block of the
        global batch (``pad_and_shard``, ``StreamingLoader``), so the terms
        sum to the JAX trainer's one mean over the global batch, its pad rows
        included as there."""
        dt = self.config.compute_dtype
        p = _cast_floats(params, getattr(torch, dt)) if dt else params
        aux = None
        with embedding_partitioning(self.ep):
            if self.fused_aux:
                logits, aux = self.model.apply_with_aux(p, batch)
            else:
                logits = self.model.apply_params(p, batch)
        logits = logits.float()
        loss = _bce_with_logits(logits, labels, weights, denom)
        if self.aux_loss_fn is not None:
            aux = self.aux_loss_fn(params, batch)
        if aux is not None:
            aux = aux.float()
            if denom is not None:  # this rank's part of the global batch's mean
                aux = aux / collectives.group_size(self.batch_group())
            loss = loss + self.aux_weight * aux
        return loss, logits

    def train_step(self, batch: Batch, labels, weights=None, denom=None):
        """One Adam step on the model's parameters; returns the pre-update
        (loss, logits), detached.

        ``denom`` marks ``batch`` as this rank's block of a data-parallel
        batch (the global ``max(sum(w), 1)``): the gradients are then summed
        over their groups before the step, and the loss over the batch group.

        Spans (``runtime/profiler.py``): ``train.forward``, ``train.backward``
        (with the gradients' sums) and ``train.optimizer`` (the Adam step);
        ``zero_grad``, which sets the gradients to None and does no device
        work, runs before them."""
        self.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            loss, logits = self.loss_fn(self._params(), batch, labels, weights, denom)
        with span("train.backward"):
            loss.backward()
            if denom is not None:
                self._sum_grads()
        with span("train.optimizer"):
            self.optimizer.step()
        loss = loss.detach()
        if denom is not None:
            loss = collectives.sum_over(loss, self.batch_group())
        return loss, logits.detach()

    def apply(self, batch: Batch) -> torch.Tensor:
        """Float32 logits of ``batch`` under the current parameters (through
        the sharded lookups while the model holds table blocks)."""
        with embedding_partitioning(self.ep):
            return self.model.apply_params(self._params(), batch).float()

    # -- state ------------------------------------------------------------
    @torch.no_grad()
    def _load(self, params: Optional[Dict[str, torch.Tensor]], opt_state: Optional[OptState]):
        named = self._params()
        if params is not None:
            for name, p in named.items():
                p.copy_(torch.as_tensor(params[name]))
        if opt_state is not None:
            for name, p in named.items():
                st = opt_state[name]
                self.optimizer.state[p] = {
                    "step": torch.as_tensor(st["step"], dtype=torch.float32).clone().cpu(),
                    "exp_avg": torch.as_tensor(st["exp_avg"]).to(p).clone(),
                    "exp_avg_sq": torch.as_tensor(st["exp_avg_sq"]).to(p).clone(),
                }

    def opt_state(self) -> OptState:
        """The Adam state by param name (a copy): step, exp_avg, exp_avg_sq."""
        out = {}
        for name, p in self._params().items():
            st = self.optimizer.state.get(p)
            if st:
                out[name] = {k: v.detach().clone() for k, v in st.items()}
        return out

    def _checksum(self) -> torch.Tensor:
        """[1]: the sum of every param and Adam moment, leaf by leaf in the
        JAX pytree's order (params by name, then first moments, then second);
        a table block's sums are summed over the model group first."""
        named = sorted(self._params().items())
        leaves = [p.detach().float().sum() for _, p in named]
        sharded = [name in self.ep_table_heights for name, _ in named]
        for key in ("exp_avg", "exp_avg_sq"):
            for name, p in named:
                if p in self.optimizer.state:
                    leaves.append(self.optimizer.state[p][key].float().sum())
                    sharded.append(name in self.ep_table_heights)
        sums = torch.stack(leaves)
        if any(sharded):
            mask = torch.tensor(sharded, device=sums.device)
            sums[mask] = collectives.sum_over(sums[mask], axis_group(self.config.mesh, MODEL_AXIS))
        return sums.sum()[None]

    # -- full training run -------------------------------------------------
    def fit(
        self,
        train: Tuple[Batch, Any],
        valid: Optional[Tuple[Batch, Any]] = None,
        test: Optional[Tuple[Batch, Any]] = None,
        weights: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        opt_state: Optional[OptState] = None,
    ) -> TrainResult:
        """Train for ``config.epochs`` full-batch epochs.

        ``weights`` maps split name ('train'/'valid'/'test') to a mask array
        for the masked-matrix mode; None = every sample counts.
        ``params``/``opt_state`` resume from a checkpoint (whole tables).
        Under a mesh each split is this rank's rows of it. Spans: ``train.fit``
        around the whole call, ``train.epoch`` around each epoch.
        """
        with span("train.fit"):
            cfg = self.config
            dev = self.device
            splits = {"train": train, "valid": valid, "test": test}
            splits = {k: _to_device(s, dev) for k, s in splits.items() if s is not None}
            weights = {k: _to_device(v, dev) for k, v in (weights or {}).items()}
            self._load(params, opt_state)
            if cfg.mesh is not None and axis_size(cfg.mesh, MODEL_AXIS) > 1:
                self._shard_tables()
            group = self.batch_group()
            dp = group is not None and collectives.group_size(group) > 1
            track = cfg.track_metrics

            def gathered(x):  # the global batch's values, on every rank
                return collectives.all_gather_tiled(x, group) if dp and x is not None else x

            # per split: the loss's global denominator, and the global labels and
            # weights of the metrics
            denom, glob = {}, {}
            for name, (_, y) in splits.items():
                w = weights.get(name)
                if dp:
                    total = (w.float().sum() if w is not None
                             else torch.tensor(float(y.shape[0]), device=y.device))
                    denom[name] = torch.clamp(collectives.sum_over(total, group), min=1.0)
                glob[name] = (gathered(y), gathered(w))

            def split_metrics(prefix, logits, labels, w):
                m = pointwise_metrics(labels, torch.sigmoid(logits), w, include_auc_raw=False)
                m = {f"{prefix}_{k}": v for k, v in m.items()}
                m[f"{prefix}_loss"] = _bce_with_logits(logits, labels, w)
                return m

            train_batch, train_y = splits["train"]
            rows = []
            for _ in range(cfg.epochs):
                with span("train.epoch"):
                    loss, logits = self.train_step(train_batch, train_y, weights.get("train"),
                                                   denom.get("train"))
                    metrics = {"train_loss": loss}
                    if track:
                        with torch.no_grad():
                            m = split_metrics("train", gathered(logits), *glob["train"])
                            metrics.update({k: v for k, v in m.items() if k != "train_loss"})
                            for name in ("valid", "test"):
                                if name in splits:
                                    lg = gathered(self.apply(splits[name][0]))
                                    metrics.update(split_metrics(name, lg, *glob[name]))
                    rows.append(metrics)
            history = {k: torch.stack([r[k] for r in rows]) for k in (rows[0] if rows else {})}

            extras: Dict[str, float] = {}
            if track:
                with torch.no_grad():
                    for name, (b, _) in splits.items():
                        probs = torch.sigmoid(gathered(self.apply(b)))
                        extras[f"{name}_auc_raw"] = float(true_auc(glob[name][0], probs,
                                                                   glob[name][1]))
            ep_heights = None
            if self.ep is not None:
                if cfg.unshard_params:
                    self._unshard_tables()
                else:
                    ep_heights = dict(self.ep_table_heights)
            history["_param_checksum"] = self._checksum()
            final = {k: v.detach().clone() for k, v in self._params().items()}
            return TrainResult(params=final, history=history, extras=extras,
                               opt_state=self.opt_state(), ep_heights=ep_heights)
