"""DCN (Deep & Cross Network): a cross network beside a deep tower.

The JAX package's ``models/dcn.py`` as an ``nn.Module`` (reference
model/deepcross.py:7-89), the ``deepcross`` preset. The reference's cross
layer is x <- x0 * (x W_l) + b_l + x with a full d x d weight (a DCN-v2-style
matrix cross, not DCN-v1's rank-1 vector), at d = 5 D + 1 over [user, item,
raw age, gender, occupation, genre]; the bias starts at zero. The deep tower
is ``relu_stack`` over d -> deep_hidden_units, and the head a Linear over
[cross, deep]. Parameters, under the JAX names:
``tables.{user,item,gender,occupation,genre}`` [V, D], ``cross.{i}.{w,b}``,
``deep.{i}.{w,b}`` and ``out.{w,b}``.

DCN has no linear part: two lookups a forward go through ``gather_rows``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models.base import init_generator
from deeplearningrecommendationsystem_tpu_torch.models.common import (
    FeatureModel,
    layer_list,
    nest,
    raw_age_concat,
    register_tree,
)
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import embed_fields, init_field_tables
from deeplearningrecommendationsystem_tpu_torch.ops.linear import (
    linear,
    linear_init,
    mlp_init,
    relu_stack,
)


class DCN(FeatureModel):
    def __init__(
        self,
        spec: FeatureSpec = ML100K_SPEC,
        cross_layers: int = 3,
        deep_hidden_units: Tuple[int, ...] = (512, 256, 128, 1),
        embedding_dim: int = 128,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.spec = spec
        self.cross_layers = cross_layers
        self.deep_hidden_units = tuple(deep_hidden_units)
        self.embedding_dim = embedding_dim
        d = 5 * embedding_dim + 1
        tables = init_field_tables(generator, spec, embedding_dim)
        cross = [{"w": linear_init(generator, d, d, bias=False)["w"],
                  "b": torch.zeros(d, device=generator.device)} for _ in range(cross_layers)]
        register_tree(self, {
            "tables": tables,
            "cross": cross,
            "deep": mlp_init(generator, (d,) + self.deep_hidden_units),
            "out": linear_init(generator, d + self.deep_hidden_units[-1], 1),
        })

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Logits [B] of a [B, 45] batch."""
        p = nest(params)
        x0 = raw_age_concat(embed_fields(p["tables"], x, self.spec), x, self.spec)
        xc = x0
        for layer in layer_list(p["cross"]):
            xc = x0 * (xc @ layer["w"]) + layer["b"] + xc
        deep = relu_stack(layer_list(p["deep"]), x0)
        return linear(p["out"], torch.cat([xc, deep], dim=-1))[:, 0]
