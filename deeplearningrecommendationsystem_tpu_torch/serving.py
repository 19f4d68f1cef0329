"""User-facing serving API: hold a model, recommend top-K for any users.

The JAX package's ``serving.py::Recommender`` on PyTorch: score the catalog
once (or per refresh), then answer per-user top-K queries, with seen-item
exclusion. ``ShardedRecommender`` and checkpoint loading are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.eval.recommend import mask_seen
from deeplearningrecommendationsystem_tpu_torch.models.base import ServingContext
from deeplearningrecommendationsystem_tpu_torch.ops.serving_topk import (
    MAX_K,
    stable_top_k,
    topk_scores,
    topk_serve_matmul,
    topk_two_stage,
)

# above this many items the factored path takes the two-stage top-k
TWO_STAGE_MIN_ITEMS = 8192


class Recommender:
    """Holds a model and serves top-K recommendations on ``device``."""

    def __init__(
        self,
        model: nn.Module,
        ctx: ServingContext,
        seen: Optional[np.ndarray] = None,  # [U, I] bool: items to exclude
        use_pallas=True,  # True = the default policy; "fused" = force the fused
        # top-k kernels; False = plain top-k over the score matrix. (The name
        # is the JAX package's; here the kernels are the CUDA ones.)
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.ctx = ctx.to(self.device)
        self.seen = (
            torch.as_tensor(seen, device=self.device) if seen is not None else None
        )
        self.use_pallas = use_pallas
        self._scores: Optional[torch.Tensor] = None

    @torch.no_grad()
    def refresh(self) -> None:
        """(Re)score the full catalog -- call after a params update."""
        scores = self.model.score_catalog(self.ctx)
        if self.seen is not None:
            scores = mask_seen(scores, self.seen)
        self._scores = scores

    @property
    def scores(self) -> torch.Tensor:
        if self._scores is None:
            self.refresh()
        return self._scores

    @property
    def shape(self):
        """(num_users, num_items) -- the server's bounds, no materialisation."""
        return (self.ctx.num_users, self.ctx.num_items)

    def _index(self, ids: Optional[Sequence[int]]) -> Optional[torch.Tensor]:
        if ids is None:
            return None
        return torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)

    def top_k_with_scores(self, k: int, users: Optional[Sequence[int]] = None):
        """(ids [n, k], scores [n, k]) as NumPy -- the HTTP server's query surface."""
        idx = self._top_k(k, users)
        u = self._index(users)
        rows = self.scores if u is None else self.scores[u]
        return idx.cpu().numpy(), torch.gather(rows, 1, idx.long()).cpu().numpy()

    def top_k(self, k: int, users: Optional[Sequence[int]] = None) -> np.ndarray:
        """[len(users), k] recommended item ids (all users by default), as NumPy."""
        return self._top_k(k, users).cpu().numpy()

    @torch.no_grad()
    def _top_k(self, k: int, users: Optional[Sequence[int]]) -> torch.Tensor:
        """[len(users), k] int32 item ids on the device.

        The JAX package's policy, with "on the TPU" read as "on the device the
        wrappers run their kernels on": for factored models the fused
        score+mask+top-k (``topk_serve_matmul``) at catalogs <= 8192 items and
        the two-stage group-max top-k above; non-factored models take a plain
        top-k over the score matrix, or the fused mask+top-k kernel
        (``topk_scores``) under ``use_pallas="fused"``. k > 128 and
        ``use_pallas=False`` take the plain stable top-k. The wrappers run
        their CUDA kernels on CUDA tensors and their plain versions on CPU
        tensors. All paths give identical lists, tie order included.
        """
        kernel_k = k <= MAX_K
        factored = hasattr(self.model, "serving_factors")
        u = self._index(users)
        if self.use_pallas and kernel_k and factored:
            P, Q = self.model.serving_factors(self.ctx)
            seen = self.seen
            if seen is None:
                seen = torch.zeros((P.shape[0], Q.shape[0]), dtype=torch.int8, device=self.device)
            if u is not None:
                P, seen = P[u], seen[u]
            if Q.shape[0] > TWO_STAGE_MIN_ITEMS and self.use_pallas != "fused":
                _, idx = topk_two_stage(P, Q, seen, k=k)
            else:
                _, idx = topk_serve_matmul(P.contiguous(), Q.contiguous(), seen.contiguous(), k=k)
            return idx
        s = self.scores
        if u is not None:
            s = s[u]
        if self.use_pallas == "fused" and kernel_k:
            # seen is already masked at refresh
            no_seen = torch.zeros(s.shape, dtype=torch.int8, device=self.device)
            _, idx = topk_scores(s.contiguous(), no_seen, k=k)
            return idx
        _, idx = stable_top_k(s, k)
        return idx.to(torch.int32)

    def score(self, user: int, items: Sequence[int]) -> np.ndarray:
        """Raw scores of specific items for one user."""
        return self.scores[user, self._index(items)].cpu().numpy()
