"""Minibatch training with row-sparse embedding updates.

The JAX package's ``train/sparse_trainer.py`` on PyTorch, on one device:

* the model's ``sparse_tables`` (vocabulary-height parameters, by name) are
  popped out of its parameters;
* each minibatch gathers only its rows, through ``ops/embedding.py::
  gather_rows`` (the gather kernel on the card) under ``no_grad``; those rows
  are the autograd leaves, so the loss is differentiated w.r.t. the gathered
  rows and no ``[V, D]`` gradient exists;
* ``train/sparse.py``'s lazy Adam or row-wise AdaGrad then updates the touched
  rows in place;
* the rest (MLPs, small field tables) trains with the dense Adam of
  ``train/optim.py``, as in the full-batch Trainer (a model with no dense
  remainder, MF, has no dense optimizer).

The sparse step ignores ``compute_dtype``, as the JAX one does: the model's
``apply_rows`` runs on the float32 rows and params. The model's parameters are
trained in place; ``history["train_loss"]`` [epochs] holds each epoch's mean
step loss, kept on the device until the end.

Spans and counters (``runtime/profiler.py``), each step: ``train.forward``
(the lookups, ``train.lookup`` inside it, and the loss), ``train.backward``,
``train.optimizer`` (the dense Adam) and ``train.sparse_update`` (every
table's dedup and row update); ``train.ids`` counts the ids looked up and,
while recording, ``train.rows_touched`` the distinct rows updated
(``train/sparse.py``).

``fit_minibatch_sparse`` draws each epoch's order as ``train/minibatch.py``
does (``epoch_order``, on the host); ``fit_stream_sparse`` streams the host
arrays through ``data/stream.py`` in the JAX package's NumPy order.

With a ``mesh`` whose model axis is larger than 1 the tables are row-sharded
(``parallel/embedding.py::shard_table``): each rank holds a row block of
every table and its row-optimizer state, the minibatch is the whole batch on
every rank (as in the JAX package, which shards no batch in this mode), the
rows come through ``sharded_gather`` (the gather kernel on the rank's block
and a sum over the model group, both ``ep_strategy`` values: the batch is
the same on every model rank), and the lazy-Adam or AdaGrad update touches
only the rank's own rows, the others' ids turned into the padding slot of
``train/sparse.py``. The dense remainder sees the same batch on every rank
and needs no collective. ``unshard`` (default) gathers the tables back whole
at the end; ``unshard=False`` leaves the blocks in the model, with
``TrainResult.ep_heights`` the tables' vocabularies.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from deeplearningrecommendationsystem_tpu_torch.data.stream import StreamingLoader
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.parallel.embedding import (
    shard_table,
    sharded_gather,
)
from deeplearningrecommendationsystem_tpu_torch.parallel.ep import (
    STRATEGIES,
    set_parameters,
    unshard_table,
)
from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size, coordinate
from deeplearningrecommendationsystem_tpu_torch.runtime.profiler import count, span
from deeplearningrecommendationsystem_tpu_torch.train import minibatch as _minibatch
from deeplearningrecommendationsystem_tpu_torch.train.optim import torch_adam
from deeplearningrecommendationsystem_tpu_torch.train.sparse import (
    LazyAdamState,
    RowwiseAdagradState,
    sparse_table_update,
)
from deeplearningrecommendationsystem_tpu_torch.train.trainer import (
    Trainer,
    TrainResult,
    _bce_with_logits,
    _to_device,
)


def pop_tables(params: Mapping[str, torch.Tensor], paths: Mapping[str, str]):
    """Split ``params`` (name -> tensor) into (dense remainder, {table: tensor})
    by the tables' parameter names; ``params`` itself is not changed."""
    dense = dict(params)
    return dense, {name: dense.pop(path) for name, path in paths.items()}


def merge_tables(params: Mapping[str, torch.Tensor], paths: Mapping[str, str],
                 tables: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pop_tables`."""
    out = dict(params)
    out.update({path: tables[name] for name, path in paths.items()})
    return out


def _check(trainer: Trainer, mesh, ep_strategy: str) -> None:
    if not hasattr(trainer.model, "sparse_tables"):
        raise TypeError(
            f"{type(trainer.model).__name__} does not implement the sparse-table protocol")
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh: a parallel/mesh.py::make_mesh DeviceMesh, got "
                        f"{type(mesh).__name__}")
    if ep_strategy not in STRATEGIES:
        raise ValueError(f"ep_strategy {ep_strategy!r}: one of {STRATEGIES}")


class _SparseRun:
    """The model's tables (its parameters' storage, updated in place; this
    rank's row blocks of them on a mesh), their row-optimizer states and the
    dense remainder's Adam."""

    def __init__(self, trainer: Trainer, optimizer: str, params: Optional[dict], mesh=None):
        model = trainer.model
        trainer._load(params, None)
        named = dict(model.named_parameters())
        self.model, self.lr = model, trainer.config.learning_rate
        self.dense, tables = pop_tables(named, model.sparse_tables)
        self.tables = {k: t.detach() for k, t in tables.items()}
        self.mesh = mesh if mesh is not None and axis_size(mesh, MODEL_AXIS) > 1 else None
        self.heights: Dict[str, int] = {}
        if self.mesh is not None:
            self.heights = {k: t.shape[0] for k, t in self.tables.items()}
            self.tables = {k: shard_table(t, self.mesh) for k, t in self.tables.items()}
        dev = trainer.device
        if optimizer == "lazy_adam":
            self.states = {k: LazyAdamState.init(t.shape[0], t.shape[1], device=dev)
                           for k, t in self.tables.items()}
        elif optimizer == "rowwise_adagrad":
            self.states = {k: RowwiseAdagradState.init(t.shape[0], device=dev)
                           for k, t in self.tables.items()}
        else:
            raise ValueError(optimizer)
        self.dense_opt = (torch_adam(self.dense.values(), self.lr, trainer.config.weight_decay)
                          if self.dense else None)

    def _local_ids(self, k: str, ids: torch.Tensor) -> torch.Tensor:
        """``ids`` into table ``k``'s block: another rank's id becomes the
        block's height, the padding sentinel of ``train/sparse.py``."""
        if self.mesh is None:
            return ids
        rows = self.tables[k].shape[0]
        local = ids.long() - coordinate(self.mesh, MODEL_AXIS) * rows
        return torch.where((local >= 0) & (local < rows), local, rows)

    def step(self, b, y) -> torch.Tensor:
        if self.dense_opt is not None:
            self.dense_opt.zero_grad(set_to_none=True)
        with span("train.forward"):
            ids = self.model.table_ids(b)
            with span("train.lookup"), torch.no_grad():
                rows = {k: (gather_rows(t, ids[k]) if self.mesh is None
                            else sharded_gather(t, ids[k].reshape(-1), self.mesh))
                        for k, t in self.tables.items()}
            count("train.ids", sum(i.numel() for i in ids.values()))
            for r in rows.values():
                r.requires_grad_(True)
            loss = _bce_with_logits(self.model.apply_rows(self.dense, rows, b), y)
        with span("train.backward"):
            loss.backward()
        with span("train.optimizer"):
            if self.dense_opt is not None:
                self.dense_opt.step()
        with span("train.sparse_update"), torch.no_grad():
            for k, table in self.tables.items():
                sparse_table_update(table, self.states[k], self._local_ids(k, ids[k]),
                                    rows[k].grad, self.lr)
        return loss.detach()

    def result(self, step_losses: Sequence[torch.Tensor], unshard: bool = True,
               keep_steps: bool = False) -> TrainResult:
        """The run's ``TrainResult``; ``step_losses``: each epoch's [steps] losses."""
        ep_heights = None
        if self.mesh is not None:
            paths = self.model.sparse_tables
            if unshard:
                named = dict(self.model.named_parameters())
                with torch.no_grad():
                    for k, t in self.tables.items():
                        named[paths[k]].copy_(unshard_table(t, self.heights[k], self.mesh))
            else:
                set_parameters(self.model, {paths[k]: t for k, t in self.tables.items()})
                ep_heights = {paths[k]: h for k, h in self.heights.items()}
        params = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        dense_state = {}
        if self.dense_opt is not None:
            for name, p in self.dense.items():
                dense_state[name] = {k: v.detach().clone()
                                     for k, v in self.dense_opt.state[p].items()}
        history = {"train_loss": torch.stack([s.mean() for s in step_losses])}
        if keep_steps:
            history["step_loss"] = torch.cat(list(step_losses))
        return TrainResult(params=params, history=history,
                           opt_state={"dense": dense_state, "sparse": self.states},
                           ep_heights=ep_heights)


def fit_minibatch_sparse(
    trainer: Trainer,
    rng,
    train: Tuple[Any, torch.Tensor],
    batch_size: int,
    optimizer: str = "lazy_adam",  # 'lazy_adam' | 'rowwise_adagrad'
    mesh: Any = None,
    ep_strategy: str = "psum",
    params: Any = None,
    unshard: bool = True,  # False: keep tables row-sharded for sharded serving
    step_losses: bool = False,  # True: history["step_loss"], every step's loss
) -> TrainResult:
    """Shuffled minibatch epochs with sparse row updates on the id tables.

    The model implements the sparse protocol (``sparse_tables``,
    ``table_ids``, ``apply_rows``: see ``models/mf.py``). ``rng`` seeds the
    host order (``train/minibatch.py::epoch_order``); ``params`` resumes the
    weights. With ``mesh`` (model axis > 1) the tables are row-sharded. With
    ``step_losses`` the history also holds ``step_loss`` [epochs * steps]."""
    _check(trainer, mesh, ep_strategy)
    batch, labels = _to_device(train, trainer.device)
    run = _SparseRun(trainer, optimizer, params, mesh)
    order = _minibatch.epoch_order(rng, labels.shape[0], trainer.config.epochs, batch_size)
    losses = [torch.stack([run.step(_minibatch.take_rows(batch, idx), labels[idx])
                           for idx in perm]) for perm in order.to(trainer.device)]
    return run.result(losses, unshard, step_losses)


def fit_stream_sparse(
    trainer: Trainer,
    rng,
    train: Tuple[Any, Any],  # tree of HOST NumPy arrays, equal leading dim
    batch_size: int,
    optimizer: str = "lazy_adam",
    mesh: Any = None,
    ep_strategy: str = "psum",
    params: Any = None,
    prefetch: int = 2,
    seed: int = 0,
    unshard: bool = True,
) -> TrainResult:
    """Row-sparse minibatch training fed by the host-streaming loader: the
    dataset stays in host memory (shuffled there with ``seed``) while the
    tables update row-sparsely. The same step as :func:`fit_minibatch_sparse`;
    only the batch source differs. ``rng`` is the JAX signature's
    initialisation key: the model already holds its weights."""
    del rng
    _check(trainer, mesh, ep_strategy)
    loader = StreamingLoader(train, batch_size, seed=seed, prefetch=prefetch,
                             device=trainer.device)
    if len(loader) == 0:
        raise ValueError(f"batch_size {batch_size} larger than the dataset ({loader.n} rows)")
    run = _SparseRun(trainer, optimizer, params, mesh)
    losses = [torch.stack([run.step(b, y) for b, y in loader.epoch()])
              for _ in range(trainer.config.epochs)]
    return run.result(losses, unshard)
