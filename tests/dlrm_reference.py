"""DLRM-DCNv2 in plain PyTorch: the CPU tests' reference for ``models/dlrm.py``.

Imports neither JAX nor anything of the port. Follows the published model
(MLPerf Training's ``recommendation_v2/torchrec_dlrm``; Wang et al., DCN V2,
arXiv:2008.13535): the bottom MLP with a ReLU after every layer, each bag
``table[ids].sum()``, x0 the dense embedding and the bags concatenated in
feature order, the low-rank cross x <- x0 * ((x v) w + b) + x, and the top
MLP with a ReLU after all layers but the last. Parameters under the port's
names (``tables.{f}``, ``bottom.{i}.{w,b}``, ``cross.{i}.{v,w,b}``,
``top.{i}.{w,b}``); float32; ``a @ b`` products throughout.

Training: autograd's dense table gradients, row-wise AdaGrad on each
table's rows whose gradient is nonzero (the accumulator the mean square of
the row's gradient, the step ``lr / (sqrt(accum) + eps)``), Adam with the
library's defaults on every other leaf.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
ADAGRAD_EPS = 1e-10


def _layers(p: Dict[str, torch.Tensor], prefix: str) -> int:
    return len({k.split(".")[1] for k in p if k.startswith(prefix + ".")})


def bags(p: Dict[str, torch.Tensor], ids: torch.Tensor,
         hotness: Sequence[int]) -> List[torch.Tensor]:
    """Each feature's pooled bag [B, D]: feature f's ids are the columns
    sum(hotness[:f]) onwards."""
    out, at = [], 0
    for f, h in enumerate(hotness):
        out.append(p[f"tables.{f}"][ids[:, at:at + h]].sum(dim=1))
        at += h
    return out


def cross(p: Dict[str, torch.Tensor], x0: torch.Tensor) -> torch.Tensor:
    x = x0
    for i in range(_layers(p, "cross")):
        x = x0 * ((x @ p[f"cross.{i}.v"]) @ p[f"cross.{i}.w"] + p[f"cross.{i}.b"]) + x
    return x


def head(p: Dict[str, torch.Tensor], dense: torch.Tensor, pooled: List[torch.Tensor]):
    """Logits [B] from the dense features and the pooled bags."""
    x = dense
    for i in range(_layers(p, "bottom")):
        x = torch.relu(x @ p[f"bottom.{i}.w"] + p[f"bottom.{i}.b"])
    x = cross(p, torch.cat([x] + pooled, dim=-1))
    n = _layers(p, "top")
    for i in range(n):
        x = x @ p[f"top.{i}.w"] + p[f"top.{i}.b"]
        if i < n - 1:
            x = torch.relu(x)
    return x[:, 0]


def logits(p: Dict[str, torch.Tensor], dense: torch.Tensor, ids: torch.Tensor,
           hotness: Sequence[int]) -> torch.Tensor:
    return head(p, dense, bags(p, ids, hotness))


def bce(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()


def train(p: Dict[str, torch.Tensor], steps, hotness: Sequence[int], lr: float):
    """Row-wise AdaGrad on the tables, Adam on the rest, one step a
    ``(dense, ids, labels)`` of ``steps``. Returns (losses, params, accums)."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    tables = [k for k in p if k.startswith("tables.")]
    accum = {k: torch.zeros(p[k].shape[0]) for k in tables}
    m = {k: torch.zeros_like(v) for k, v in p.items() if k not in accum}
    v2 = {k: torch.zeros_like(v) for k, v in p.items() if k not in accum}
    losses = []
    for t, (dense, ids, y) in enumerate(steps, start=1):
        loss = bce(logits(p, dense, ids, hotness), y)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in grads.items():
                if k in accum:
                    rows = g.abs().sum(dim=1).nonzero()[:, 0]
                    gr = g[rows]
                    accum[k][rows] += (gr * gr).mean(dim=1)
                    p[k][rows] -= (lr / (accum[k][rows].sqrt() + ADAGRAD_EPS))[:, None] * gr
                    continue
                b1, b2 = ADAM_BETAS
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                step = lr * (m[k] / (1 - b1 ** t)) / ((v2[k] / (1 - b2 ** t)).sqrt() + ADAM_EPS)
                p[k].sub_(step)
    return losses, {k: v.detach() for k, v in p.items()}, accum
