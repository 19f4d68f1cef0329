"""NeuralCF: GMF tower || MLP tower -> joint projection.

The JAX package's ``models/neuralcf.py`` as an ``nn.Module`` (reference
model/neuralcf.py:7-73): GMF is the elementwise product of ``mf_dim`` user
and item embeddings; the MLP tower runs the concat of two ``layers[0] // 2``
embeddings through a ReLU stack and projects it back to ``mf_dim``; the two
towers, concatenated, give one logit. Parameters, under the JAX names:
``gmf_user``, ``gmf_item``, ``mlp_user``, ``mlp_item``, ``mlp.{i}.{w,b}``,
``proj`` and ``out``. The four lookups are ``gather_rows`` (the gather and
``onehot_grad`` kernel pair); the towers are plain torch. The catalog is
``catalog_scores_from_pairs``: NeuralCF has no serving factors, so
``Recommender(use_pallas="fused")`` serves it through ``topk_scores``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.models.base import (
    ServingContext,
    catalog_scores_from_pairs,
    init_generator,
)
from deeplearningrecommendationsystem_tpu_torch.models.common import layer_list, nest, register_tree
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import (
    embedding_init,
    linear,
    linear_init,
    mlp_init,
)


class NeuralCF(nn.Module):
    def __init__(
        self,
        num_users: int,
        num_items: int,
        mf_dim: int = 256,
        layers: Sequence[int] = (512, 256, 128, 64, 32),
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.num_users = num_users
        self.num_items = num_items
        self.mf_dim = mf_dim
        self.layers = tuple(layers)
        half = self.layers[0] // 2
        register_tree(self, {
            "gmf_user": embedding_init(generator, num_users, mf_dim),
            "gmf_item": embedding_init(generator, num_items, mf_dim),
            "mlp_user": embedding_init(generator, num_users, half),
            "mlp_item": embedding_init(generator, num_items, half),
            "mlp": mlp_init(generator, self.layers),
            "proj": linear_init(generator, self.layers[-1], mf_dim),
            "out": linear_init(generator, 2 * mf_dim, 1),
        })

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def apply_params(self, params: Mapping[str, Any], batch) -> torch.Tensor:
        """Logits [B] of a (users [B], items [B]) batch."""
        p = nest(params)
        users, items = batch
        gmf = gather_rows(p["gmf_user"], users) * gather_rows(p["gmf_item"], items)
        x = torch.cat([gather_rows(p["mlp_user"], users), gather_rows(p["mlp_item"], items)],
                      dim=-1)
        for layer in layer_list(p["mlp"]):
            x = torch.relu(linear(layer, x))
        mlp_vec = linear(p["proj"], x)
        return linear(p["out"], torch.cat([gmf, mlp_vec], dim=-1))[:, 0]

    def forward(self, batch) -> torch.Tensor:
        return self.apply_params(self.params(), batch)

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        return catalog_scores_from_pairs(self.apply_params, self.params(), self.num_users,
                                         self.num_items, self.gmf_user.device)
