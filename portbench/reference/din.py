"""DIN in plain PyTorch: the reference the benchmark holds the program to.

Deep Interest Network (Zhou et al., KDD 2018), as the reference repository's
``model/din.py`` computes it: an item embedding shared by the history and the
target; the activation unit, an MLP over ``[h, h - t, t]`` per history
position (ReLU between layers, the last linear), softmax over the positions,
the weighted sum of the history as the user's interest; the head, an MLP over
``[interest, t]`` to one logit. Training batches are a fixed window of
``hist_len`` positions, left-padded with item 0 and not masked; serving scores
each user's complete history, unpadded, against every item. Float32 throughout, every product through ``mm``.

Parameters, by name: ``item`` [I, D]; ``att.{0,1,2}.{w,b}`` (3D -> A1 -> A2
-> 1) and ``fc.{0,1,2}.{w,b}`` (2D -> F1 -> F2 -> 1). Initial weights: the
table Xavier-normal, each linear layer U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from portbench import feed
from portbench.refcommon import bce_with_logits, linear


def _layers(prefix: str, dims: Sequence[int]) -> List[Tuple[str, tuple, str, float]]:
    out = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / d_in ** 0.5
        out += [(f"{prefix}.{i}.w", (d_in, d_out), "uniform", bound),
                (f"{prefix}.{i}.b", (d_out,), "uniform", bound)]
    return out


def param_specs(config: Dict, num_users: int, num_items: int):
    """(name, shape, init, scale) of every parameter."""
    kw = config["model_kwargs"]
    D = kw["embed_size"]
    specs = [("item", (num_items, D), "normal", (2.0 / (num_items + D)) ** 0.5)]
    specs += _layers("att", [3 * D, *kw["attention_units"]])
    specs += _layers("fc", [2 * D, *kw["fc_units"]])
    return specs


def _mlp(mm: Callable, p: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor, n: int):
    for i in range(n):
        x = linear(mm, x, p[f"{prefix}.{i}.w"], p[f"{prefix}.{i}.b"])
        if i < n - 1:
            x = torch.relu(x)
    return x


def logits(mm: Callable, p: Dict[str, torch.Tensor], hist: torch.Tensor, target: torch.Tensor,
           n_att: int = 3, n_fc: int = 3) -> torch.Tensor:
    """Logits [B] of histories hist [B, L] (every position real) against
    targets [B]."""
    item = p["item"]
    hist_e, target_e = item[hist.long()], item[target.long()]
    t = target_e[:, None, :].expand_as(hist_e)
    scores = _mlp(mm, p, "att", torch.cat([hist_e, hist_e - t, t], dim=-1), n_att)[..., 0]
    w = torch.softmax(scores, dim=-1)
    interest = (w[..., None] * hist_e).sum(dim=1)
    return _mlp(mm, p, "fc", torch.cat([interest, target_e], dim=-1), n_fc)[:, 0]


def _depths(config: Dict) -> Tuple[int, int]:
    kw = config["model_kwargs"]
    return len(kw["attention_units"]), len(kw["fc_units"])


def train_loss(mm: Callable, config: Dict, p: Dict[str, torch.Tensor], batch,
               labels: torch.Tensor) -> torch.Tensor:
    """The mean BCE of a (hist [B, L], target [B]) batch."""
    hist, target = batch
    n_att, n_fc = _depths(config)
    return bce_with_logits(logits(mm, p, hist, target, n_att, n_fc), labels)


def train_batch(raw: feed.Raw, train, batch, labels, config: Dict):
    """The reference's training batch, built from the fixture and the
    training split (``feed.history_batch``): (batch, labels, mismatch)."""
    return feed.history_batch(raw, train, batch, labels, config["hist_len"])


def serving_mismatch(raw: feed.Raw, ctx) -> int:
    """The users whose complete history the program serves wrong."""
    return feed.histories_mismatch(raw, ctx.full_histories)


@torch.no_grad()
def catalog_scores(mm: Callable, config: Dict, p: Dict[str, torch.Tensor], inputs: Dict,
                   users: Sequence[int], positions: int = 1 << 20) -> torch.Tensor:
    """[len(users), I] logits of every item against each user's complete
    history, in blocks of items of at most ``positions`` history positions."""
    item = p["item"]
    dev = item.device
    num_items = item.shape[0]
    hists = feed.histories(inputs["users"], inputs["items"], inputs["num_users"])
    n_att, n_fc = _depths(config)
    out = torch.empty((len(users), num_items), dtype=torch.float32, device=dev)
    for row, u in enumerate(users):
        h = torch.as_tensor(hists[u], dtype=torch.int64, device=dev)
        block = max(1, positions // max(1, h.shape[0]))
        for i0 in range(0, num_items, block):
            tgt = torch.arange(i0, min(num_items, i0 + block), device=dev)
            hist = h[None, :].expand(tgt.shape[0], h.shape[0])
            out[row, i0:i0 + tgt.shape[0]] = logits(mm, p, hist, tgt, n_att, n_fc)
    return out
