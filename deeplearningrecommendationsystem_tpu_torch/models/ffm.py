"""FFM: a field-aware factorization machine over six fields and two domains.

The JAX package's ``models/ffm.py`` as an ``nn.Module`` (reference
model/ffm.py:7-98): each of the six fields (age, gender, occupation, genre,
user id, item id) owns two latent tables of width ``num_vector``, a "user"
and an "item" domain vector, and the 15 field-pair dot products combine the
domain sides the reference chose (``PAIRS``, model/ffm.py:62-80), summed in
its order. Its quirk is kept: the scalar cross sum is added to every dense
column before the linear part's Linear (model/ffm.py:84-86).

Parameters: the JAX tables are keyed ``"{field}.{domain}"`` (``"user_id.user"``),
and a parameter name may not hold a dot, so each field is a submodule of
``tables`` with a parameter per domain: ``tables.{field}.{domain}`` [V, K],
which is the dotted name the JAX tree's leaf takes (``weights.py``), and
``lr.{user_bias,item_bias,wide.{w,b}}``.

Six lookups a forward go through ``gather_rows``: both domains of the user
and item id tables, and the two bias tables.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models.base import init_generator
from deeplearningrecommendationsystem_tpu_torch.models.common import (
    FeatureModel,
    linear_part_init,
    nest,
    register_tree,
)
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import embedding_init, linear

# (left field, left domain, right field, right domain) of the 15 pair dots,
# in the reference's order (model/ffm.py:62-80)
PAIRS = (
    ("age", "user", "gender", "user"),
    ("age", "user", "occupation", "user"),
    ("age", "item", "genre", "user"),
    ("age", "user", "user_id", "user"),
    ("age", "item", "item_id", "user"),
    ("gender", "user", "occupation", "user"),
    ("gender", "item", "genre", "user"),
    ("gender", "user", "user_id", "user"),
    ("gender", "item", "item_id", "user"),
    ("occupation", "item", "genre", "user"),
    ("occupation", "user", "user_id", "user"),
    ("occupation", "item", "item_id", "user"),
    ("genre", "user", "user_id", "item"),
    ("genre", "item", "item_id", "item"),
    ("user_id", "item", "item_id", "user"),
)
DOMAINS = ("user", "item")


class FFM(FeatureModel):
    onehot_serving = True  # the JAX class attribute; a TPU gather policy, no effect here

    def __init__(
        self,
        spec: FeatureSpec = ML100K_SPEC,
        num_vector: int = 32,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.spec = spec
        self.num_vector = num_vector
        sizes = {"age": 1, "gender": spec.num_genders, "occupation": spec.num_occupations,
                 "genre": spec.num_genres, "user_id": spec.num_users,
                 "item_id": spec.num_items}
        tables = {field: {domain: embedding_init(generator, n, num_vector) for domain in DOMAINS}
                  for field, n in sizes.items()}
        register_tree(self, {"tables": tables, "lr": linear_part_init(generator, spec)})

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Logits [B] of a [B, 45] batch."""
        p = nest(params)
        user, item, age, gender, occupation, genre = self.spec.split(x)
        t, lr = p["tables"], p["lr"]
        blocks = {"age": age, "gender": gender, "occupation": occupation, "genre": genre}
        emb = {}
        for domain in DOMAINS:
            for field, block in blocks.items():
                table = t[field][domain]
                emb[(field, domain)] = block.to(table.dtype) @ table
            emb[("user_id", domain)] = gather_rows(t["user_id"][domain], user)
            emb[("item_id", domain)] = gather_rows(t["item_id"][domain], item)

        dtype = t["user_id"]["user"].dtype
        cross = torch.zeros((x.shape[0],), dtype=dtype, device=x.device)
        for lf, ld, rf, rd in PAIRS:
            cross = cross + (emb[(lf, ld)] * emb[(rf, rd)]).sum(dim=-1)
        dense_plus_cross = self.spec.dense(x).to(dtype) + cross[:, None]  # reference quirk
        logits = (gather_rows(lr["user_bias"], user) + gather_rows(lr["item_bias"], item)
                  + linear(lr["wide"], dense_plus_cross))
        return logits[:, 0]
