"""Wide&Deep: the LR wide part beside an embedding-concat deep tower.

The JAX package's ``models/widedeep.py`` as an ``nn.Module`` (reference
model/widedeep.py:8-79). The deep input is [user, item, raw age, gender,
occupation, genre] (5 D + 1); the first projection has no activation and
every later layer ReLUs its output, the last included (a reference quirk,
model/widedeep.py:51-57). Parameters, under the JAX names:
``tables.{user,item,gender,occupation,genre}`` [V, D], ``deep_in.{w,b}``,
``deep.{i}.{w,b}``, ``wide.{user_bias,item_bias,wide.{w,b}}`` and
``out.{w,b}``.

``robust_init`` starts the last tower bias at 0.1: with full-batch training
about half of the init seeds collapse the ReLU-terminated tower for good, in
the JAX package and the torch reference alike; the presets keep the
reference's init. Four lookups a forward go through ``gather_rows``: the two
id tables and the two bias tables.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models.base import init_generator
from deeplearningrecommendationsystem_tpu_torch.models.common import (
    FeatureModel,
    linear_part,
    linear_part_init,
    nest,
    raw_age_concat,
    register_tree,
    tower,
    tower_init,
)
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import embed_fields, init_field_tables
from deeplearningrecommendationsystem_tpu_torch.ops.linear import linear, linear_init


class WideDeep(FeatureModel):
    onehot_serving = True  # the JAX class attribute; a TPU gather policy, no effect here

    def __init__(
        self,
        spec: FeatureSpec = ML100K_SPEC,
        hidden_units: Tuple[int, ...] = (512, 256, 128, 1),
        embedding_dim: int = 128,
        robust_init: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.spec = spec
        self.hidden_units = tuple(hidden_units)
        self.embedding_dim = embedding_dim
        self.robust_init = robust_init
        register_tree(self, {
            "tables": init_field_tables(generator, spec, embedding_dim),
            **tower_init(generator, 5 * embedding_dim + 1, self.hidden_units, robust_init),
            "wide": linear_part_init(generator, spec),
            "out": linear_init(generator, 2, 1),
        })

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Logits [B] of a [B, 45] batch."""
        p = nest(params)
        e = embed_fields(p["tables"], x, self.spec)
        deep = tower(p, raw_age_concat(e, x, self.spec))
        wide = linear_part(p["wide"], x, self.spec)
        return linear(p["out"], torch.cat([wide, deep], dim=-1))[:, 0]
