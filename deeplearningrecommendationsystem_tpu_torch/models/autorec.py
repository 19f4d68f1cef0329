"""AutoRec: a sigmoid autoencoder over rating-matrix rows (U- and I-AutoRec).

The JAX package's ``models/autorec.py`` as an ``nn.Module`` (reference
model/autorec.py:5-24): logits = decoder(sigmoid(encoder(x))), the outer
sigmoid left to the trainer's BCE-with-logits. It trains in the Trainer's
weighted mode: only rated entries (not 0.5) weigh in the loss (reference
trainer/trainer.py:81-113). U- and I-AutoRec differ only in the data: a
user-major [U, I] matrix (``num_input`` = I) or its item-major [I, U]
transpose (``num_input`` = U), which ``score_catalog`` turns back to [U, I].
Parameters, under the JAX names: ``encoder.{w,b}``, ``decoder.{w,b}``; both
linears are plain torch (XLA in the JAX package), so AutoRec launches no
kernel until ``Recommender(use_pallas="fused")`` serves its catalog through
``topk_scores``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.models.base import ServingContext, init_generator
from deeplearningrecommendationsystem_tpu_torch.models.common import nest, register_tree
from deeplearningrecommendationsystem_tpu_torch.ops.linear import linear, linear_init


class AutoRec(nn.Module):
    def __init__(
        self,
        num_input: int,  # num_items for U-AutoRec, num_users for I-AutoRec
        hidden_units: int = 256,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.num_input = num_input
        self.hidden_units = hidden_units
        register_tree(self, {"encoder": linear_init(generator, num_input, hidden_units),
                             "decoder": linear_init(generator, hidden_units, num_input)})

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        """[B, num_input] matrix rows -> [B, num_input] logits. The rows are cast
        to the weights' dtype, as the JAX trainer casts its batch (0, 0.5 and 1
        are exact in bf16)."""
        p = nest(params)
        hidden = torch.sigmoid(linear(p["encoder"], x.to(p["encoder"]["w"].dtype)))
        return linear(p["decoder"], hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_params(self.params(), x)

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        """[U, I] logits from the whole rating matrix in ``ctx``; I-AutoRec's
        [I, U] result is transposed (the reference transposes its lists
        instead, scripts/i-autorec.py:65)."""
        if ctx.rating_matrix is None:
            raise ValueError("AutoRec serving needs ctx.rating_matrix")
        scores = self.apply_params(self.params(), ctx.rating_matrix)
        return scores if scores.shape[0] == ctx.num_users else scores.T
