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
  backward, the master weights stay float32 and the loss is float32;
* ``extras[f"{split}_auc_raw"]`` is the true AUC on the final params;
* ``history["_param_checksum"]`` ([1]) sums every final param and Adam
  moment (not Adam's step count).

The model holds its parameters (an ``nn.Module`` with ``apply_params``); ``fit``
trains them in place. The JAX ``rng`` argument is gone: the model draws its
initial weights when it is built. ``fit(params=..., opt_state=...)`` resumes
from a ``TrainResult``'s ``params`` and ``opt_state`` (or from the JAX
package's, through ``weights.py``).

Row-sharded tables (``mesh``) are not ported yet (``ROADMAP.md`` §1 item 13).
The JAX config's gather-route flags have no counterpart: every route is the
same kernel pair here (``ops/embedding.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.eval.pointwise import pointwise_metrics, true_auc
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
    mesh: Any = None  # row-sharded tables: not ported yet, must stay None


@dataclasses.dataclass
class TrainResult:
    params: Dict[str, torch.Tensor]  # name -> final tensor (detached copy)
    history: Dict[str, torch.Tensor]  # each entry [epochs], on the device
    extras: Dict[str, float] = dataclasses.field(default_factory=dict)
    opt_state: Optional[OptState] = None  # for resume

    def last(self) -> Dict[str, float]:
        out = {k: float(v[-1]) for k, v in self.history.items() if not k.startswith("_")}
        out.update(self.extras)
        return out


def _bce_with_logits(logits, labels, weights=None):
    losses = F.binary_cross_entropy_with_logits(logits, labels, reduction="none")
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

    def __init__(self, model: nn.Module, config: TrainConfig, device: str | torch.device = "cuda"):
        if config.mesh is not None:
            raise NotImplementedError(
                "row-sharded (EP) training is not ported yet; see ROADMAP.md §1 item 13")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.config = config
        self.optimizer = torch_adam(self.model.parameters(), config.learning_rate,
                                    config.weight_decay)

    def _params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    # -- single step ------------------------------------------------------
    def loss_fn(self, params: Dict[str, torch.Tensor], batch: Batch, labels, weights=None):
        """(loss, logits): both float32, under the ``compute_dtype`` policy."""
        dt = self.config.compute_dtype
        if dt:
            dtype = getattr(torch, dt)
            params, batch = _cast_floats(params, dtype), _cast_floats(batch, dtype)
        logits = self.model.apply_params(params, batch).float()
        return _bce_with_logits(logits, labels, weights), logits

    def train_step(self, batch: Batch, labels, weights=None):
        """One Adam step on the model's parameters; returns the pre-update
        (loss, logits), detached."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, logits = self.loss_fn(self._params(), batch, labels, weights)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), logits.detach()

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
        JAX pytree's order (params by name, then first moments, then second)."""
        named = sorted(self._params().items())
        leaves = [p.detach().float().sum() for _, p in named]
        for key in ("exp_avg", "exp_avg_sq"):
            leaves += [self.optimizer.state[p][key].float().sum()
                       for _, p in named if p in self.optimizer.state]
        return torch.stack(leaves).sum()[None]

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
        ``params``/``opt_state`` resume from a checkpoint.
        """
        cfg = self.config
        dev = self.device
        train, valid, test = (_to_device(s, dev) for s in (train, valid, test))
        weights = {k: _to_device(v, dev) for k, v in (weights or {}).items()}
        self._load(params, opt_state)
        track = cfg.track_metrics
        apply = self.model.apply_params

        def split_metrics(prefix, logits, labels, w):
            m = pointwise_metrics(labels, torch.sigmoid(logits), w, include_auc_raw=False)
            m = {f"{prefix}_{k}": v for k, v in m.items()}
            m[f"{prefix}_loss"] = _bce_with_logits(logits, labels, w)
            return m

        train_batch, train_y = train
        rows = []
        for _ in range(cfg.epochs):
            loss, logits = self.train_step(train_batch, train_y, weights.get("train"))
            metrics = {"train_loss": loss}
            if track:
                with torch.no_grad():
                    m = split_metrics("train", logits, train_y, weights.get("train"))
                    metrics.update({k: v for k, v in m.items() if k != "train_loss"})
                    for name, split in (("valid", valid), ("test", test)):
                        if split is not None:
                            b, y = split
                            lg = apply(self._params(), b).float()
                            metrics.update(split_metrics(name, lg, y, weights.get(name)))
            rows.append(metrics)
        history = {k: torch.stack([r[k] for r in rows]) for k in (rows[0] if rows else {})}
        history["_param_checksum"] = self._checksum()

        extras: Dict[str, float] = {}
        if track:
            with torch.no_grad():
                for name, split in (("train", train), ("valid", valid), ("test", test)):
                    if split is None:
                        continue
                    b, y = split
                    probs = torch.sigmoid(apply(self._params(), b).float())
                    extras[f"{name}_auc_raw"] = float(true_auc(y, probs, weights.get(name)))
        final = {k: v.detach().clone() for k, v in self._params().items()}
        return TrainResult(params=final, history=history, extras=extras,
                           opt_state=self.opt_state())
