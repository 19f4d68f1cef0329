"""User-facing serving API: hold a model, recommend top-K for any users.

The JAX package's ``serving.py::Recommender`` on PyTorch: score the catalog
once (or per refresh), then answer per-user top-K queries, with seen-item
exclusion; ``Recommender.from_checkpoint`` serves the params of a
``runtime/checkpoint.py`` checkpoint. ``ShardedRecommender`` serves from
row-sharded tables (``parallel/serving.py``), every rank of the mesh calling
it alike.
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
from deeplearningrecommendationsystem_tpu_torch.runtime.profiler import span

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

    @classmethod
    def from_checkpoint(cls, model: nn.Module, checkpoint_dir: str, ctx: ServingContext,
                        seen=None, device: str | torch.device = "cuda") -> "Recommender":
        """Load the latest checkpoint's ``state["params"]`` into ``model`` (its
        names and shapes checked against the model's), then serve it."""
        from deeplearningrecommendationsystem_tpu_torch.runtime.checkpoint import (
            CheckpointManager,
        )

        mgr = CheckpointManager(checkpoint_dir)
        state = mgr.restore(template={"params": model.state_dict()}, device=device)
        mgr.close()
        model.load_state_dict(state["params"])
        return cls(model, ctx, seen, device=device)

    @torch.no_grad()
    def refresh(self) -> None:
        """(Re)score the full catalog -- call after a params update. Span:
        ``serve.refresh``."""
        with span("serve.refresh"):
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
        """(ids [n, k], scores [n, k]) as NumPy -- the HTTP server's query
        surface. Span: ``serve.top_k``."""
        with span("serve.top_k"):
            idx = self._top_k(k, users)
            u = self._index(users)
            rows = self.scores if u is None else self.scores[u]
            return idx.cpu().numpy(), torch.gather(rows, 1, idx.long()).cpu().numpy()

    def top_k(self, k: int, users: Optional[Sequence[int]] = None) -> np.ndarray:
        """[len(users), k] recommended item ids (all users by default), as
        NumPy. Span: ``serve.top_k``."""
        with span("serve.top_k"):
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


class ShardedRecommender:
    """Serves top-K directly from EP-SHARDED params (``parallel/serving.py``).

    For tables trained with ``unshard_params=False`` at vocabularies where a
    replicated table does not fit on one device: item rows never leave their
    block; each query is a local top-k on every model rank plus a small
    ``[U, m * k]`` candidate exchange, list-identical to :class:`Recommender`
    on the equivalent dense params. Every rank of the mesh makes the same
    calls in the same order (they run collectives) and gets the same answer.
    ``params``: name -> tensor, the sharded tables this rank's blocks (a
    ``TrainResult``'s or ``ExperimentResult``'s params).
    """

    def __init__(self, model: nn.Module, params, ctx: ServingContext, mesh, seen=None,
                 device: str | torch.device = "cuda"):
        from deeplearningrecommendationsystem_tpu_torch.parallel.ep import (
            EmbeddingPartitioning,
            is_table_name,
        )
        from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size

        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.params = {k: torch.as_tensor(v, device=self.device) for k, v in params.items()}
        self.ctx = ctx.to(self.device)
        self.mesh = mesh
        self.seen = torch.as_tensor(seen, device=self.device) if seen is not None else None
        # EP routing for per-pair scoring (/v1/score): the padded heights of
        # the row-sharded vocab tables, picked as training picks them; a
        # query's ids are the same on every model rank, so the psum lookup
        m = axis_size(mesh, MODEL_AXIS)
        full = (self.ctx.num_users, self.ctx.num_items)
        heights = {leaf.shape[0] * m for name, leaf in self.params.items()
                   if leaf.dim() == 2 and is_table_name(name) and leaf.shape[0] not in full}
        self._ep = EmbeddingPartitioning(mesh=mesh, strategy="psum",
                                         sharded_heights=frozenset(heights))

    @property
    def shape(self):
        return (self.ctx.num_users, self.ctx.num_items)

    def refresh(self) -> None:
        """No-op: queries run directly against the sharded tables (there is
        no replicated score matrix to materialise -- that's the point)."""

    def top_k(self, k: int, users: Optional[Sequence[int]] = None) -> np.ndarray:
        return self.top_k_with_scores(k, users)[0]

    def top_k_with_scores(self, k: int, users: Optional[Sequence[int]] = None):
        from deeplearningrecommendationsystem_tpu_torch.parallel.serving import (
            sharded_catalog_topk,
        )

        u = None if users is None else np.asarray(users, dtype=np.int64)
        vals, idx = sharded_catalog_topk(self.model, self.params, self.ctx, self.mesh, k,
                                         seen=self.seen, users=u)
        return idx.cpu().numpy(), vals.cpu().numpy()

    @torch.no_grad()
    def score(self, user: int, items: Sequence[int]) -> np.ndarray:
        """Scores of specific items for one user, from the sharded tables: the
        model's own forward with every vocab-table lookup EP-routed through
        the training collectives. Seen items return the dense server's mask
        value, so /v1/score answers match between the dense and sharded
        servers."""
        from deeplearningrecommendationsystem_tpu_torch.parallel.ep import embedding_partitioning

        items_t = torch.as_tensor(np.asarray(items, dtype=np.int64), device=self.device)
        u = torch.full(items_t.shape, int(user), dtype=torch.int64, device=self.device)
        with embedding_partitioning(self._ep):
            if hasattr(self.model, "spec"):  # feature family: 45-column rows
                n = items_t.shape[0]
                uf = self.ctx.user_features.float()
                x = torch.cat([u.float()[:, None], items_t.float()[:, None],
                               uf[int(user)][None, :].expand(n, uf.shape[1]),
                               self.ctx.item_features.float()[items_t]], dim=1)
                logits = self.model.apply_params(self.params, x)
            else:  # pair family (MF/NeuralCF shapes)
                logits = self.model.apply_params(self.params, (u, items_t))
        if self.seen is not None:
            logits = mask_seen(logits, self.seen[int(user), items_t])
        return logits.float().cpu().numpy()
