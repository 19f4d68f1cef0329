"""DLRM-DCNv2 in plain PyTorch: the reference the benchmark holds the program to.

MLPerf Training's recommendation model (mlcommons/training
``recommendation_v2/torchrec_dlrm``, torchrec's ``DLRM_DCN``; Wang et al.,
DCN V2, arXiv:2008.13535): the bottom MLP over the 13 dense features with a
ReLU after every layer; each of the 26 bags ``table[ids].sum()`` over its
fixed number of ids; x0 the bottom MLP's output and the bags concatenated in
feature order; the low-rank cross x <- x0 * ((x V) W + b) + x, three layers;
the top MLP with a ReLU after all layers but the last. Float32 throughout,
every product through ``mm``.

Parameters, by name: ``tables.{f}`` [V_f, D] (V_f the rows held, the
configuration's ``cat_f`` where it gives one, else the published rows);
``bottom.{i}.{w,b}``, ``cross.{i}.{v,w,b}`` and ``top.{i}.{w,b}``. Initial
weights as torchrec draws them: the tables U(-sqrt(1/V), sqrt(1/V)) with V
the published rows (a held block is a slice of the whole table), filled in
place on the device from the run's seed, table after table
(``fill_tables``); the cross's V and W Xavier-normal and its bias zero; the
MLPs U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (``dense_specs``, drawn by
``weights.py``).

Training (``train``): the steps' batches one after another; autograd's
dense table gradients, applied row-wise on each table's rows whose gradient
is nonzero by row-wise AdaGrad (the accumulator the mean square of a row's
gradient, the step ``lr / (sqrt(accum) + 1e-10)``); Adam on every other
leaf. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from portbench.refcommon import ADAM_BETAS, ADAM_EPS, bce_with_logits, linear

ADAGRAD_EPS = 1e-10
# the tables' generator starts from the run's seed plus this, apart from the
# generator of the dense leaves (weights.py, the seed itself)
TABLE_STREAM = 1 << 40


def heights(config: Dict) -> List[int]:
    """The rows held of each feature's table."""
    return [int(config.get(f"cat_{f}", v))
            for f, v in enumerate(config["num_embeddings_per_feature"])]


def hotness(config: Dict) -> List[int]:
    return [int(h) for h in config["multi_hot_sizes"]]


def _linear_specs(prefix: str, dims: Sequence[int]):
    out = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / d_in ** 0.5
        out += [(f"{prefix}.{i}.w", (d_in, d_out), "uniform", bound),
                (f"{prefix}.{i}.b", (d_out,), "uniform", bound)]
    return out


def dense_specs(config: Dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, init, scale) of every parameter but the tables."""
    D, r = config["embedding_dim"], config["dcn_low_rank_dim"]
    d = (len(config["multi_hot_sizes"]) + 1) * D
    specs = _linear_specs("bottom", [config["num_dense_features"]]
                          + list(config["dense_arch_layer_sizes"]))
    std = (2.0 / (d + r)) ** 0.5
    for i in range(config["dcn_num_layers"]):
        specs += [(f"cross.{i}.v", (d, r), "normal", std), (f"cross.{i}.w", (r, d), "normal", std),
                  (f"cross.{i}.b", (d,), "uniform", 0.0)]
    return specs + _linear_specs("top", [d] + list(config["over_arch_layer_sizes"]))


@torch.no_grad()
def fill_tables(config: Dict, seed: int, tables: Sequence[torch.Tensor]) -> None:
    """Draw every table in place, in feature order, from one generator on
    their device."""
    g = torch.Generator(device=tables[0].device)
    g.manual_seed(seed + TABLE_STREAM)
    for t, v in zip(tables, config["num_embeddings_per_feature"]):
        bound = (1.0 / v) ** 0.5
        t.uniform_(-bound, bound, generator=g)


def logits(mm: Callable, config: Dict, p: Dict[str, torch.Tensor], dense: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """Logits [B] of dense [B, 13] and ids [B, sum(hotness)], feature f's ids
    in the columns sum(hotness[:f]) onwards."""
    x = dense
    for i in range(len(config["dense_arch_layer_sizes"])):
        x = torch.relu(linear(mm, x, p[f"bottom.{i}.w"], p[f"bottom.{i}.b"]))
    fields, at = [x], 0
    for f, h in enumerate(hotness(config)):
        fields.append(p[f"tables.{f}"][ids[:, at:at + h]].sum(dim=1))
        at += h
    x0 = x = torch.cat(fields, dim=-1)
    for i in range(config["dcn_num_layers"]):
        x = x0 * (mm(mm(x, p[f"cross.{i}.v"]), p[f"cross.{i}.w"]) + p[f"cross.{i}.b"]) + x
    n = len(config["over_arch_layer_sizes"])
    for i in range(n):
        x = linear(mm, x, p[f"top.{i}.w"], p[f"top.{i}.b"])
        if i < n - 1:
            x = torch.relu(x)
    return x[:, 0]


def train_loss(mm: Callable, config: Dict, p: Dict[str, torch.Tensor], batch: Dict,
               labels: torch.Tensor) -> torch.Tensor:
    """The mean BCE of a batch ``{"dense", "ids"}``."""
    return bce_with_logits(logits(mm, config, p, batch["dense"], batch["ids"]), labels)


def ids_mismatch(config: Dict, rows: torch.Tensor, ids: torch.Tensor) -> int:
    """The row numbers of the program's lookup (``rows``, [N * 214]: the 26
    tables one after another, in feature order) that differ from each id of
    ``ids`` [N, 214] plus its table's first row, as the reference places
    them; a lookup of another length counts whole."""
    base, at = [], 0
    for v, h in zip(heights(config), hotness(config)):
        base += [at] * h
        at += v
    want = (ids + torch.tensor(base, device=ids.device)).reshape(-1)
    if rows.shape != want.shape:
        return want.numel()
    return int((rows != want).sum())


def train(mm: Callable, config: Dict, dense_params: Dict[str, torch.Tensor], seed: int,
          steps: Sequence[Tuple[Dict, torch.Tensor]], lr: float,
          touched: Sequence[torch.Tensor]) -> Dict:
    """The tables drawn from ``seed`` on the device of ``dense_params``, then
    one step a batch of ``steps`` (each ``({"dense", "ids"}, labels)``).

    Returns each step's loss; the first step's gradient of every dense leaf;
    the dense leaves after the last step; and each table's rows ``touched[f]``
    before the first step (``rows0``) and after the last (``rows``)."""
    dev = next(iter(dense_params.values())).device
    D = config["embedding_dim"]
    tables = [torch.empty((v, D), dtype=torch.float32, device=dev) for v in heights(config)]
    fill_tables(config, seed, tables)
    rows0 = [t[i] for t, i in zip(tables, touched)]
    p = {k: v.detach().clone() for k, v in dense_params.items()}
    p.update({f"tables.{f}": t for f, t in enumerate(tables)})
    for v in p.values():
        v.requires_grad_(True)
    accum = [torch.zeros(t.shape[0], device=dev) for t in tables]
    m = {k: torch.zeros_like(v) for k, v in dense_params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in dense_params.items()}
    b1, b2 = ADAM_BETAS
    losses, first_grad = [], {}
    for t, (batch, labels) in enumerate(steps, start=1):
        loss = train_loss(mm, config, p, batch, labels)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(loss.detach())
        with torch.no_grad():
            for f, table in enumerate(tables):
                g = grads.pop(f"tables.{f}")
                rows = g.abs().sum(dim=1).nonzero()[:, 0]
                g = g[rows]
                acc = accum[f][rows] + (g * g).mean(dim=1)
                accum[f][rows] = acc
                table[rows] -= (lr / (acc.sqrt() + ADAGRAD_EPS))[:, None] * g
            del g
            for k, g in grads.items():
                if t == 1:
                    first_grad[k] = g.clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                p[k].sub_(lr * (m[k] / (1 - b1 ** t)) / ((v2[k] / (1 - b2 ** t)).sqrt() + ADAM_EPS))
        del grads
    return {"losses": torch.stack(losses).float().cpu().tolist(), "first_grad": first_grad,
            "dense": {k: p[k].detach() for k in dense_params},
            "rows0": rows0, "rows": [t.detach()[i] for t, i in zip(tables, touched)]}
