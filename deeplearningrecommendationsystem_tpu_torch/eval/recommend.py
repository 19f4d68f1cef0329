"""Full-catalog recommendation: masked ranking on the device.

Masking seen scores to ``NEG_INF`` before sorting yields the same ordered list
of unseen items as removing them from a sorted list. Every sort here is
stable, so equal scores keep index order, as JAX's sorts and ``lax.top_k`` do.
"""

from __future__ import annotations

import torch

from deeplearningrecommendationsystem_tpu_torch.ops.serving_topk import NEG_INF, stable_top_k


def mask_seen(scores: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """Push seen items to the bottom of the ranking. [U, I] -> [U, I]."""
    return torch.where(seen != 0, NEG_INF, scores)


def top_k_unseen(scores: torch.Tensor, seen: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [U, k] of the best unseen items per user."""
    _, idx = stable_top_k(mask_seen(scores, seen), k)
    return idx.to(torch.int32)


def full_ranking(scores: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """Full descending item ranking [U, I] with seen items forced to the tail."""
    return torch.argsort(-mask_seen(scores, seen), dim=1, stable=True).to(torch.int32)


def score_ranking(scores: torch.Tensor) -> torch.Tensor:
    """Plain descending ranking [U, I] -- sort the catalog once, then derive
    any number of per-split filtered lists with :func:`seen_to_tail`."""
    return torch.argsort(-scores, dim=1, stable=True).to(torch.int32)


def seen_to_tail(rec_full: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """Move a split's seen items to the tail of a precomputed ranking.

    A stable partition on the boolean seen flag keeps the score order within
    each side, without re-sorting the catalog scores per split.
    """
    rec = rec_full.long()
    flags = torch.gather(seen, 1, rec).to(torch.uint8)
    order = torch.argsort(flags, dim=1, stable=True)
    return torch.gather(rec, 1, order).to(rec_full.dtype)
