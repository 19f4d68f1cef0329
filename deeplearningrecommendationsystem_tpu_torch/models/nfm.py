"""NFM: the first-order linear part beside bi-interaction pooling fed to a tower.

The JAX package's ``models/nfm.py`` as an ``nn.Module`` (reference
model/nfm.py:8-84): the O(F^2) elementwise double loop is the sum-square
bi-interaction identity over the six embedded fields (age through its
table). Parameters, under the JAX names:
``tables.{user,item,age,gender,occupation,genre}`` [V, D], ``deep_in.{w,b}``
(D -> hidden_units[0]), ``deep.{i}.{w,b}``,
``wide.{user_bias,item_bias,wide.{w,b}}`` and ``out.{w,b}``.

* ``f32_cross``: under a bf16 compute dtype the bi-interaction (a
  sum-square difference, which cancels) is summed in float32 and cast back
  to the fields' dtype; the tower stays in the compute dtype.
* ``robust_init``: the last tower bias starts at 0.1 (see
  ``models/widedeep.py``).

Four lookups a forward go through ``gather_rows``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models.base import init_generator
from deeplearningrecommendationsystem_tpu_torch.models.common import (
    FIELDS,
    FeatureModel,
    linear_part,
    linear_part_init,
    nest,
    register_tree,
    stack_fields,
    tower,
    tower_init,
)
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import embed_fields, init_field_tables
from deeplearningrecommendationsystem_tpu_torch.ops.interactions import bi_interaction
from deeplearningrecommendationsystem_tpu_torch.ops.linear import linear, linear_init


class NFM(FeatureModel):
    onehot_serving = True  # the JAX class attribute; a TPU gather policy, no effect here

    def __init__(
        self,
        spec: FeatureSpec = ML100K_SPEC,
        hidden_units: Tuple[int, ...] = (512, 256, 128, 1),
        embedding_dim: int = 128,
        robust_init: bool = False,
        f32_cross: bool = True,
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
        self.f32_cross = f32_cross
        register_tree(self, {
            "tables": init_field_tables(generator, spec, embedding_dim, FIELDS),
            **tower_init(generator, embedding_dim, self.hidden_units, robust_init),
            "wide": linear_part_init(generator, spec),
            "out": linear_init(generator, 2, 1),
        })

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Logits [B] of a [B, 45] batch."""
        p = nest(params)
        fields = stack_fields(embed_fields(p["tables"], x, self.spec))  # [B, 6, D]
        if self.f32_cross:
            cross = bi_interaction(fields.float()).to(fields.dtype)
        else:
            cross = bi_interaction(fields)  # [B, D]
        deep = tower(p, cross)
        wide = linear_part(p["wide"], x, self.spec)
        return linear(p["out"], torch.cat([wide, deep], dim=-1))[:, 0]
