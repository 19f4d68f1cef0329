"""DeepFM: the FM part (linear + sum-square second order) beside a deep tower.

The JAX package's ``models/deepfm.py`` as an ``nn.Module`` (reference
model/deepfm.py:8-94): six embedded fields (user, item, age through its
table, gender, occupation, genre); the FM cross term by the sum-square
identity; the ReLU tower over the 6 D concat; a final Linear(2, 1) over
[FM, deep]. Parameters, under the JAX names:
``tables.{user,item,age,gender,occupation,genre}`` [V, D], ``deep_in.{w,b}``,
``deep.{i}.{w,b}``, ``fm_linear.{user_bias,item_bias,wide.{w,b}}`` and
``out.{w,b}``.

* ``f32_fm``: under a bf16 compute dtype the FM sum-square term and the
  linear part are summed in float32 and cast to the tower's dtype only at the
  concat; the tower stays in the compute dtype.
* ``robust_init``: the last tower bias starts at 0.1, so the ReLU-terminated
  tower is born alive (the presets keep the reference's init).
* ``onehot_serving`` was a TPU gather policy for catalog scoring and has no
  effect here.

The id fields and the two bias tables go through ``gather_rows`` (the gather
and ``onehot_grad`` kernel pair): four lookups a forward.

The sparse-row protocol of ``train/sparse_trainer.py``: the four
vocabulary-height tables (the user and item embeddings and their biases) are
``sparse_tables`` and train with a row optimizer; the small field tables and
the tower stay dense. ``apply_rows`` is ``apply_params`` with those four
lookups replaced by the gathered rows.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

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
from deeplearningrecommendationsystem_tpu_torch.ops.interactions import fm_cross_term
from deeplearningrecommendationsystem_tpu_torch.ops.linear import linear, linear_init


class DeepFM(FeatureModel):
    onehot_serving = True  # the JAX class attribute; a TPU gather policy, no effect here

    def __init__(
        self,
        spec: FeatureSpec = ML100K_SPEC,
        hidden_units: Tuple[int, ...] = (512, 256, 128, 1),
        embedding_dim: int = 128,
        robust_init: bool = False,
        f32_fm: bool = True,
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
        self.f32_fm = f32_fm
        register_tree(self, {
            "tables": init_field_tables(generator, spec, embedding_dim, FIELDS),
            **tower_init(generator, 6 * embedding_dim, self.hidden_units, robust_init),
            "fm_linear": linear_part_init(generator, spec),
            "out": linear_init(generator, 2, 1),
        })

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Logits [B] of a [B, 45] batch."""
        p = nest(params)
        fields = stack_fields(embed_fields(p["tables"], x, self.spec))  # [B, 6, D]
        deep = tower(p, fields.reshape(fields.shape[0], -1))
        fm_fields = fields.float() if self.f32_fm else fields
        fm = (linear_part(p["fm_linear"], x, self.spec).to(fm_fields.dtype)
              + fm_cross_term(fm_fields)[:, None])
        return linear(p["out"], torch.cat([fm.to(deep.dtype), deep], dim=-1))[:, 0]

    # -- sparse-row protocol (train/sparse_trainer.py) ----------------------
    sparse_tables = {
        "user": "tables.user",
        "item": "tables.item",
        "user_bias": "fm_linear.user_bias",
        "item_bias": "fm_linear.item_bias",
    }

    def table_ids(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        u, i = self.spec.ids(x)
        return {"user": u, "item": i, "user_bias": u, "item_bias": i}

    def apply_rows(self, dense: Mapping[str, Any], rows: Mapping[str, torch.Tensor],
                   x: torch.Tensor) -> torch.Tensor:
        """``apply_params`` with the four tables' lookups given as ``rows``;
        ``dense`` is the params without those tables (``embed_fields`` then
        embeds only the remaining fields)."""
        p = nest(dense)
        e = embed_fields(p["tables"], x, self.spec)
        e["user"], e["item"] = rows["user"], rows["item"]
        fields = stack_fields(e)  # [B, 6, D]
        deep = tower(p, fields.reshape(fields.shape[0], -1))
        fm_fields = fields.float() if self.f32_fm else fields
        w = p["fm_linear"]["wide"]
        wide = rows["user_bias"] + rows["item_bias"] + linear(w, self.spec.dense(x).to(w["w"].dtype))
        fm = wide.to(fm_fields.dtype) + fm_cross_term(fm_fields)[:, None]
        return linear(p["out"], torch.cat([fm.to(deep.dtype), deep], dim=-1))[:, 0]
