"""Matrix Factorization: sigmoid(<p_u, q_i>).

The JAX package's ``models/mf.py`` as an ``nn.Module``: the ``user`` and
``item`` tables are parameters of those names (the JAX pytree's keys), and
serving is the full ``P @ Q^T`` score matrix. Training (``fast_fit``, the
one-hot epoch and the sparse protocol) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.models.base import ServingContext
from deeplearningrecommendationsystem_tpu_torch.ops.linear import embedding_init


class MatrixFactorization(nn.Module):
    def __init__(
        self,
        num_users: int,
        num_items: int,
        embedding_dim: int = 64,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if generator.device.type != dev.type:
            raise ValueError(f"generator is on {generator.device}, the model on {dev}")
        self.num_users = num_users
        self.num_items = num_items
        self.embedding_dim = embedding_dim
        self.user = nn.Parameter(embedding_init(generator, num_users, embedding_dim))
        self.item = nn.Parameter(embedding_init(generator, num_items, embedding_dim))

    def forward(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.user[users] * self.item[items], dim=-1)

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        return self.user @ self.item.T

    def serving_factors(self, ctx: ServingContext):
        """(P, Q) with scores == P @ Q^T -- feeds the fused score+mask+top-k
        kernel (ops/serving_topk.py) without materialising the [U, I] scores."""
        return self.user, self.item
