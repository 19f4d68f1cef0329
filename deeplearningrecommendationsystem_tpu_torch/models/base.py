"""Model protocol and the serving context.

A model here is an ``nn.Module`` holding its parameters, with

* ``forward(batch) -> logits`` (pre-sigmoid scores), and
* ``score_catalog(ctx) -> [U, I] logits`` -- the serving path,

and, for factored models, ``serving_factors(ctx) -> (P, Q)`` with
``scores == P @ Q^T``, which lets serving fuse scoring, the seen mask and the
top-k into one kernel without materialising [U, I].

``catalog_scores_from_features`` scores the full catalog for a
feature-vector model, one tile of users at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device


def init_generator(generator: Optional[torch.Generator],
                   device: str | torch.device) -> torch.Generator:
    """The generator a model draws its initial weights from: ``generator``, or
    one seeded with 0 on ``device``; it must lie on the model's device type."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the model on {dev}")
    return generator


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


def catalog_scores_from_features(apply_fn: Callable, params: Any, ctx: ServingContext,
                                 tile: int = 64) -> torch.Tensor:
    """[U, I] logits of a feature-vector model, ``apply_fn(params, x [B, 45])
    -> [B]``.

    The JAX package's ``lax.map`` over user tiles is a Python loop here: each
    tile of ``tile`` users builds its [tile * I, 45] feature block on the
    device (user id, item id, user block, item block broadcast together) and
    scores it in one call, so the all-pairs matrix never exists at once. The
    last tile is shorter instead of padded.
    """
    U, I = ctx.num_users, ctx.num_items
    dev = ctx.user_features.device
    uf = ctx.user_features.float()
    item_block = torch.cat(
        [torch.arange(I, dtype=torch.float32, device=dev)[:, None], ctx.item_features.float()], 1
    )  # [I, 20]
    scores = torch.empty((U, I), dtype=torch.float32, device=dev)
    for u0 in range(0, U, tile):
        ids = torch.arange(u0, min(U, u0 + tile), device=dev)
        T = ids.shape[0]
        u_col = ids.float()[:, None, None].expand(T, I, 1)
        u_feat = uf[ids][:, None, :].expand(T, I, uf.shape[1])
        i_blk = item_block[None].expand(T, I, item_block.shape[1])
        x = torch.cat([u_col, i_blk[..., :1], u_feat, i_blk[..., 1:]], dim=-1)
        scores[u0:u0 + T] = apply_fn(params, x.reshape(T * I, -1)).reshape(T, I)
    return scores
