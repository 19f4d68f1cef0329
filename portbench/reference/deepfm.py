"""DeepFM in plain PyTorch: the reference the benchmark holds the program to.

DeepFM (Guo et al., IJCAI 2017), as the reference repository's
``model/deepfm.py`` computes it over ml-100k's 45-column feature rows
``[user id, item id, age, gender (2), occupation (21), genres (19)]``: six
fields embedded to D (the ids through their tables, age as the scalar times
its one-row table, the one- and multi-hot blocks times theirs); the FM part,
a linear part (a user bias, an item bias and a linear layer over the 43 dense
columns) plus the second-order term sum_{i<j} <e_i, e_j>; the deep part, a
linear layer over the six fields concatenated, then a stack of linear layers
each followed by a ReLU, the last included; a final linear layer over
[FM, deep]. Float32 throughout, every product through ``mm``.

Parameters, by name: ``tables.{user,item,age,gender,occupation,genre}``
[V, D]; ``deep_in.{w,b}`` (6D -> H0); ``deep.{i}.{w,b}`` (H_i -> H_i+1);
``fm_linear.{user_bias,item_bias}`` [V, 1]; ``fm_linear.wide.{w,b}`` (43 ->
1); ``out.{w,b}`` (2 -> 1). Initial weights: tables Xavier-normal, linear
layers U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from portbench import feed
from portbench.refcommon import bce_with_logits, linear

FIELDS = ("user", "item", "age", "gender", "occupation", "genre")
DENSE = {"age": (2, 3), "gender": (3, 5), "occupation": (5, 26), "genre": (26, 45)}


def _linear_spec(name: str, d_in: int, d_out: int) -> List[Tuple[str, tuple, str, float]]:
    bound = 1.0 / d_in ** 0.5
    return [(f"{name}.w", (d_in, d_out), "uniform", bound),
            (f"{name}.b", (d_out,), "uniform", bound)]


def _normal(name: str, rows: int, cols: int):
    return (name, (rows, cols), "normal", (2.0 / (rows + cols)) ** 0.5)


def param_specs(config: Dict, num_users: int, num_items: int):
    """(name, shape, init, scale) of every parameter."""
    kw = config["model_kwargs"]
    D, H = kw["embedding_dim"], list(kw["hidden_units"])
    vocab = {"user": num_users, "item": num_items, "age": 1,
             **{f: hi - lo for f, (lo, hi) in DENSE.items() if f != "age"}}
    specs = [_normal(f"tables.{f}", vocab[f], D) for f in FIELDS]
    specs += _linear_spec("deep_in", 6 * D, H[0])
    for i, (a, b) in enumerate(zip(H[:-1], H[1:])):
        specs += _linear_spec(f"deep.{i}", a, b)
    specs += [_normal("fm_linear.user_bias", num_users, 1),
              _normal("fm_linear.item_bias", num_items, 1)]
    specs += _linear_spec("fm_linear.wide", 43, 1)
    specs += _linear_spec("out", 2, 1)
    return specs


def logits(mm: Callable, p: Dict[str, torch.Tensor], x: torch.Tensor, depth: int) -> torch.Tensor:
    """Logits [B] of feature rows x [B, 45]."""
    u, i = x[:, 0].long(), x[:, 1].long()
    fields = [p["tables.user"][u], p["tables.item"][i]]
    for f in FIELDS[2:]:
        lo, hi = DENSE[f]
        fields.append(mm(x[:, lo:hi], p[f"tables.{f}"]))
    e = torch.stack(fields, dim=1)  # [B, 6, D]
    s = e.sum(dim=1)
    cross = 0.5 * (s * s - (e * e).sum(dim=1)).sum(dim=-1)
    wide = (p["fm_linear.user_bias"][u] + p["fm_linear.item_bias"][i]
            + linear(mm, x[:, 2:], p["fm_linear.wide.w"], p["fm_linear.wide.b"]))
    fm = wide + cross[:, None]
    deep = linear(mm, e.reshape(e.shape[0], -1), p["deep_in.w"], p["deep_in.b"])
    for j in range(depth):
        deep = torch.relu(linear(mm, deep, p[f"deep.{j}.w"], p[f"deep.{j}.b"]))
    return linear(mm, torch.cat([fm, deep], dim=-1), p["out.w"], p["out.b"])[:, 0]


def _depth(config: Dict) -> int:
    return len(config["model_kwargs"]["hidden_units"]) - 1


def train_loss(mm: Callable, config: Dict, p: Dict[str, torch.Tensor], batch,
               labels: torch.Tensor) -> torch.Tensor:
    """The mean BCE of a [B, 45] batch."""
    return bce_with_logits(logits(mm, p, batch, _depth(config)), labels)


def train_batch(raw: feed.Raw, train, batch, labels, config: Dict):
    """The reference's [N, 45] training rows, built from the fixture
    (``feed.feature_batch``): (rows, labels, mismatch)."""
    return feed.feature_batch(raw, train, batch, labels)


def serving_mismatch(raw: feed.Raw, ctx) -> int:
    """The user and item feature rows the program serves wrong."""
    return feed.features_mismatch(raw, ctx.user_features, ctx.item_features)


@torch.no_grad()
def catalog_scores(mm: Callable, config: Dict, p: Dict[str, torch.Tensor], inputs: Dict,
                   users: Sequence[int], user_block: int = 32) -> torch.Tensor:
    """[len(users), I] logits of every (user, item) pair, ``user_block`` users
    at a time; each row built from the user's and the item's features."""
    uf, itf = inputs["user_features"], inputs["item_features"]
    dev = p["out.w"].device
    num_items = itf.shape[0]
    users_t = torch.as_tensor(list(users), dtype=torch.int64, device=dev)
    item_ids = torch.arange(num_items, device=dev)
    out = torch.empty((len(users_t), num_items), dtype=torch.float32, device=dev)
    for r0 in range(0, len(users_t), user_block):
        ub = users_t[r0:r0 + user_block]
        uu = ub.repeat_interleave(num_items)
        ii = item_ids.repeat(ub.shape[0])
        x = torch.cat([uu[:, None].float(), ii[:, None].float(), uf[uu], itf[ii]], dim=1)
        out[r0:r0 + ub.shape[0]] = logits(mm, p, x, _depth(config)).reshape(ub.shape[0], num_items)
    return out
