"""Matrix Factorization: sigmoid(<p_u, q_i>).

The JAX package's ``models/mf.py`` as an ``nn.Module``: the ``user`` and
``item`` tables are parameters of those names (the JAX pytree's keys).

* ``apply_params(params, batch)`` is the JAX ``apply`` (``nn.Module.apply``
  has another meaning): logits of ``(users, items)`` under a dict of tables,
  which may be cast copies (the trainer's ``compute_dtype``);
  ``forward(users, items)`` applies the module's own.
  Both look the rows up through ``ops/embedding.gather_rows``, whose forward
  and backward are the gather kernels.
* ``fast_fit`` trains through the fused MF kernel (``ops/mf_epoch.py``).
* Serving is the full ``P @ Q^T`` score matrix, or the factors for the fused
  top-k kernel.

``onehot_epoch`` is accepted for the JAX field of that name: the ``[D, B]``
one-hot layout was a TPU workaround for its slow native gather, and the
lookup computes the same function through the same kernels either way.

The sparse-row protocol of ``train/sparse_trainer.py``: ``sparse_tables``
names the two tables (by parameter name), ``table_ids`` gives a batch's ids
into each, and ``apply_rows`` computes the logits from the gathered rows, so
a minibatch step is differentiated w.r.t. those rows and never forms a
``[V, D]`` gradient. MF has no dense remainder.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.models.base import ServingContext, init_generator
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import embedding_init
from deeplearningrecommendationsystem_tpu_torch.ops.mf_epoch import mf_fullbatch_train


class MatrixFactorization(nn.Module):
    def __init__(
        self,
        num_users: int,
        num_items: int,
        embedding_dim: int = 64,
        onehot_epoch: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.num_users = num_users
        self.num_items = num_items
        self.embedding_dim = embedding_dim
        self.onehot_epoch = onehot_epoch
        self.user = nn.Parameter(embedding_init(generator, num_users, embedding_dim))
        self.item = nn.Parameter(embedding_init(generator, num_items, embedding_dim))

    def apply_params(self, params: Dict[str, torch.Tensor], batch) -> torch.Tensor:
        users, items = batch
        return torch.sum(
            gather_rows(params["user"], users) * gather_rows(params["item"], items), dim=-1
        )

    def forward(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        return self.apply_params({"user": self.user, "item": self.item}, (users, items))

    @torch.no_grad()
    def fast_fit(self, params: Dict[str, torch.Tensor], batch, y: torch.Tensor, epochs: int,
                 learning_rate: float, weight_decay: float = 0.0,
                 compute_dtype: str = "bfloat16") -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Full-batch Adam training through the fused kernel: gathers, loss,
        backward and the torch-Adam update of every epoch, one launch for the
        whole run. The same semantics as ``Trainer.fit`` with this
        ``compute_dtype``; returns (params, losses [epochs]) and leaves the
        module's own tables as they are."""
        users, items = batch
        pu, pi, losses = mf_fullbatch_train(
            users.contiguous(), items.contiguous(), y.float().contiguous(),
            params["user"].detach().float().contiguous(),
            params["item"].detach().float().contiguous(),
            epochs, learning_rate, weight_decay, compute_dtype,
        )
        return {"user": pu, "item": pi}, losses

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        return self.user @ self.item.T

    def serving_factors(self, ctx: ServingContext):
        """(P, Q) with scores == P @ Q^T -- feeds the fused score+mask+top-k
        kernel (ops/serving_topk.py) without materialising the [U, I] scores."""
        return self.user, self.item

    # -- sparse-row protocol (train/sparse_trainer.py) ----------------------
    sparse_tables = {"user": "user", "item": "item"}

    def table_ids(self, batch) -> Dict[str, torch.Tensor]:
        users, items = batch
        return {"user": users, "item": items}

    def apply_rows(self, dense: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
                   batch) -> torch.Tensor:
        return torch.sum(rows["user"] * rows["item"], dim=-1)
