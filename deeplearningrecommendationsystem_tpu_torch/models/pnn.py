"""PNN: a product layer (inner or outer mode) fed to a ReLU DNN.

The JAX package's ``models/pnn.py`` as an ``nn.Module`` (reference
model/pnn.py:27-143): lz = Linear(the concat of the six field embeddings),
lp = Linear(the pairwise inner products) in ``mode="in"`` or Linear(the
summed field vector) in ``mode="out"``; lz + lp feeds the ReLU DNN and a
scalar head. The outer mode is the JAX package's repaired per-sample form
(the reference's transposes the batch axis into the outer product and runs
only for B == D; the summed field vector fully determines its rank-1 outer
product). Parameters, under the JAX names:
``tables.{user,item,age,gender,occupation,genre}`` [V, D], ``lz.{w,b}``,
``lp.{w,b}``, ``dnn.{i}.{w,b}`` and ``out.{w,b}``.

PNN has no linear part: two lookups a forward go through ``gather_rows``,
the user and item tables.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models.base import init_generator
from deeplearningrecommendationsystem_tpu_torch.models.common import (
    FIELDS,
    FeatureModel,
    layer_list,
    nest,
    register_tree,
    stack_fields,
)
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import embed_fields, init_field_tables
from deeplearningrecommendationsystem_tpu_torch.ops.interactions import pairwise_inner_products
from deeplearningrecommendationsystem_tpu_torch.ops.linear import (
    linear,
    linear_init,
    mlp_init,
    relu_stack,
)

MODES = ("in", "out")


class PNN(FeatureModel):
    def __init__(
        self,
        spec: FeatureSpec = ML100K_SPEC,
        embedding_dim: int = 256,
        hidden_units: Tuple[int, ...] = (256, 128, 64, 32),
        mode: str = "in",
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        generator = init_generator(generator, device)
        self.spec = spec
        self.embedding_dim = embedding_dim
        self.hidden_units = tuple(hidden_units)
        self.mode = mode
        F = len(FIELDS)
        lp_in = F * (F - 1) // 2 if mode == "in" else embedding_dim
        register_tree(self, {
            "tables": init_field_tables(generator, spec, embedding_dim, FIELDS),
            "lz": linear_init(generator, F * embedding_dim, self.hidden_units[0]),
            "lp": linear_init(generator, lp_in, self.hidden_units[0]),
            "dnn": mlp_init(generator, self.hidden_units),
            "out": linear_init(generator, self.hidden_units[-1], 1),
        })

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Logits [B] of a [B, 45] batch."""
        p = nest(params)
        fields = stack_fields(embed_fields(p["tables"], x, self.spec))  # [B, F, D]
        z = fields.reshape(fields.shape[0], -1)
        if self.mode == "in":
            prod = pairwise_inner_products(fields)  # [B, F(F-1)/2]
        else:
            prod = fields.sum(dim=1)  # [B, D]
        h = relu_stack(layer_list(p["dnn"]), linear(p["lz"], z) + linear(p["lp"], prod))
        return linear(p["out"], h)[:, 0]
