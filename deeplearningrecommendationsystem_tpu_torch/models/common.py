"""The linear part shared by every feature-vector model, and the parameter trees.

The reference repeats the same "LR head" in eight models: a 1-dim user-id
bias table + a 1-dim item-id bias table + a Linear over the 43 dense columns
(e.g. model/lr.py:24-25). ``linear_part_init`` and ``linear_part`` are the JAX
package's ``models/common.py``.

A model's parameters are nested dicts in the JAX package. Here they are an
``nn.Module`` tree with the same names (``params_module``), so
``named_parameters()`` gives the JAX leaves under dotted names ("wide.w"), and
``nest`` turns such a flat dict back into the nested one the model functions
read.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import bias_embedding_init, gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import linear, linear_init


def params_module(tree: Mapping[str, Any]) -> nn.Module:
    """An ``nn.Module`` holding the tensors of a nested dict as parameters, a
    nested dict becoming a submodule of the same name."""
    module = nn.Module()
    for name, value in tree.items():
        if isinstance(value, Mapping):
            module.add_module(name, params_module(value))
        else:
            module.register_parameter(name, nn.Parameter(value))
    return module


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
    """user_bias[u] + item_bias[i] + W . dense + b  -> [B, 1].

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
        + linear(p["wide"], spec.dense(x))
    )
