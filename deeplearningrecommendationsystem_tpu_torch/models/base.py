"""Model protocol and the serving context.

A model here is an ``nn.Module`` holding its parameters, with

* ``forward(batch) -> logits`` (pre-sigmoid scores), and
* ``score_catalog(ctx) -> [U, I] logits`` -- the serving path,

and, for factored models, ``serving_factors(ctx) -> (P, Q)`` with
``scores == P @ Q^T``, which lets serving fuse scoring, the seen mask and the
top-k into one kernel without materialising [U, I].
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ServingContext:
    """Device-resident feature blocks needed to score the full catalog."""

    user_features: torch.Tensor  # [U, 24] = [age, gender(2), occupation(21)]
    item_features: torch.Tensor  # [I, 19] genre flags

    @property
    def num_users(self) -> int:
        return self.user_features.shape[0]

    @property
    def num_items(self) -> int:
        return self.item_features.shape[0]

    def to(self, device: torch.device) -> "ServingContext":
        return dataclasses.replace(
            self,
            user_features=torch.as_tensor(self.user_features, device=device),
            item_features=torch.as_tensor(self.item_features, device=device),
        )
