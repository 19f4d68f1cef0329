"""The linear part shared by every feature-vector model, and the parameter trees.

The reference repeats the same "LR head" in eight models: a 1-dim user-id
bias table + a 1-dim item-id bias table + a Linear over the 43 dense columns
(e.g. model/lr.py:24-25). ``linear_part_init`` and ``linear_part`` are the JAX
package's ``models/common.py``.

A model's parameters are nested dicts in the JAX package. Here they are an
``nn.Module`` tree with the same names (``params_module``), so
``named_parameters()`` gives the JAX leaves under dotted names ("wide.w", a
list's items under their index: "deep.0.w"), and ``nest`` turns such a flat
dict back into the nested one the model functions read (``layer_list`` turns
a list's {"0": ..., "1": ...} back into a list).

``FIELDS``, ``stack_fields`` and ``raw_age_concat`` are the two field layouts
of the models over six embedded fields: stacked [B, 6, D] with age through its
table (DeepFM, NFM, PNN), and concatenated [B, 5 D + 1] with the raw age
scalar (WideDeep, DCN, DeepCrossing).

``FeatureModel`` is what the feature models share: ``params``, ``forward``
and ``score_catalog`` over the model's ``apply_params``. Under a bf16 compute
dtype the Trainer casts the params but not the [B, 45] feature matrix (the
JAX trainer casts the whole matrix, which rounds ids above 256 in its id
columns); here the ids stay exact, and each dense block is cast to the dtype
of the weights it meets (``embed_fields``, ``linear_part``,
``raw_age_concat``), which gives the JAX model's numbers wherever its ids
survive the cast.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models.base import (
    ServingContext,
    catalog_scores_from_features,
)
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import bias_embedding_init, gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import (
    linear,
    linear_init,
    mlp_init,
    relu_stack,
)


FIELDS = ("user", "item", "age", "gender", "occupation", "genre")


def params_module(tree: Mapping[str, Any] | Sequence[Any]) -> nn.Module:
    """An ``nn.Module`` holding the tensors of a nested dict as parameters, a
    nested dict becoming a submodule of the same name and a list an
    ``nn.ModuleList``."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList(params_module(value) for value in tree)
    module = nn.Module()
    register_tree(module, tree)
    return module


def register_tree(module: nn.Module, tree: Mapping[str, Any]) -> None:
    """Register each entry of ``tree`` on ``module``: a tensor as a parameter,
    a dict or list as a submodule (``params_module``)."""
    for name, value in tree.items():
        if isinstance(value, torch.Tensor):
            module.register_parameter(name, nn.Parameter(value))
        else:
            module.add_module(name, params_module(value))


def layer_list(tree: Mapping[str, Any]) -> List[Any]:
    """{"0": layer, "1": layer, ...} (a list as ``nest`` gives it back) ->
    [layer, layer, ...]."""
    return [tree[str(i)] for i in range(len(tree))]


def stack_fields(e: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The six embedded fields stacked in ``FIELDS`` order: [B, 6, D]."""
    return torch.stack([e[f] for f in FIELDS], dim=1)


def raw_age_concat(e: Mapping[str, torch.Tensor], x: torch.Tensor,
                   spec: FeatureSpec) -> torch.Tensor:
    """[user, item, raw age, gender, occupation, genre] -> [B, 5 D + 1]: the
    age column in the embeddings' dtype."""
    age = x[:, spec.age_col:spec.age_col + 1].to(e["user"].dtype)
    return torch.cat([e["user"], e["item"], age, e["gender"], e["occupation"], e["genre"]],
                     dim=-1)


def nest(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """{"wide.w": t, ...} -> {"wide": {"w": t}, ...}; a nested dict passes through."""
    out: Dict[str, Any] = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def linear_part_init(generator: torch.Generator, spec: FeatureSpec,
                     dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """{"user_bias": [U, 1], "item_bias": [I, 1], "wide": {"w": [43, 1], "b": [1]}}."""
    return {
        "user_bias": bias_embedding_init(generator, spec.num_users, dtype),
        "item_bias": bias_embedding_init(generator, spec.num_items, dtype),
        "wide": linear_init(generator, spec.dense_width, 1, dtype=dtype),
    }


def linear_part(p: Mapping[str, Any], x: torch.Tensor, spec: FeatureSpec,
                gather: Optional[Callable] = None) -> torch.Tensor:
    """user_bias[u] + item_bias[i] + W . dense + b  -> [B, 1], the dense block
    cast to W's dtype (see ``ops/embedding.py::embed_fields``).

    ``gather`` is the JAX argument that picked the bias lookup's route (the
    native gather or a one-hot-matmul backward); every route is
    ``gather_rows`` here, the gather and ``onehot_grad`` kernel pair, so a
    given ``gather`` is accepted and takes that same route.
    """
    del gather  # one route: ops/embedding.py
    u, i = spec.ids(x)
    return (
        gather_rows(p["user_bias"], u)
        + gather_rows(p["item_bias"], i)
        + linear(p["wide"], spec.dense(x).to(p["wide"]["w"].dtype))
    )


def tower_init(generator: torch.Generator, d_in: int, hidden_units: Tuple[int, ...],
               robust_init: bool) -> Dict[str, Any]:
    """``deep_in`` (d_in -> hidden_units[0]) and ``deep`` (the stack over
    hidden_units), the last bias 0.1 under ``robust_init``: the tower of
    DeepFM, WideDeep and NFM."""
    deep_in = linear_init(generator, d_in, hidden_units[0])
    deep = mlp_init(generator, hidden_units)
    if robust_init:
        deep[-1]["b"] = torch.full_like(deep[-1]["b"], 0.1)
    return {"deep_in": deep_in, "deep": deep}


def tower(p: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
    """relu_stack(deep, deep_in(x))."""
    return relu_stack(layer_list(p["deep"]), linear(p["deep_in"], x))


class FeatureModel(nn.Module):
    """A model over the [B, 45] feature matrix, with ``apply_params(params,
    x) -> logits [B]``."""

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_params(self.params(), x)

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        return catalog_scores_from_features(self.apply_params, self.params(), ctx)
