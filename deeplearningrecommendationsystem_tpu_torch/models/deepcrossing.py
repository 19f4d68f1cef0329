"""DeepCrossing: the embedding stack through residual units to a scalar head.

The JAX package's ``models/deepcrossing.py`` as an ``nn.Module`` (reference
model/deepcrossing.py:8-92): a residual block is ReLU(down(ReLU(up(r))) + r),
one block for each entry of ``hidden_units`` (its inner width), over the
stack [user, item, raw age, gender, occupation, genre] of width 5 D + 1.
Parameters, under the JAX names: ``tables.{user,item,gender,occupation,genre}``
[V, D], ``blocks.{i}.{up,down}.{w,b}`` and ``out.{w,b}``.

DeepCrossing has no linear part: two lookups a forward go through
``gather_rows``.
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
from deeplearningrecommendationsystem_tpu_torch.ops.linear import linear, linear_init


class DeepCrossing(FeatureModel):
    onehot_serving = True  # the JAX class attribute; a TPU gather policy, no effect here

    def __init__(
        self,
        spec: FeatureSpec = ML100K_SPEC,
        embedding_dim: int = 32,
        hidden_units: Tuple[int, ...] = (256, 128, 64, 32),
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.spec = spec
        self.embedding_dim = embedding_dim
        self.hidden_units = tuple(hidden_units)
        d = 5 * embedding_dim + 1
        tables = init_field_tables(generator, spec, embedding_dim)
        blocks = [{"up": linear_init(generator, d, h), "down": linear_init(generator, h, d)}
                  for h in self.hidden_units]
        register_tree(self, {"tables": tables, "blocks": blocks,
                             "out": linear_init(generator, d, 1)})

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Logits [B] of a [B, 45] batch."""
        p = nest(params)
        r = raw_age_concat(embed_fields(p["tables"], x, self.spec), x, self.spec)
        for blk in layer_list(p["blocks"]):
            r = torch.relu(linear(blk["down"], torch.relu(linear(blk["up"], r))) + r)
        return linear(p["out"], r)[:, 0]
