"""Feature-interaction ops (FM / NFM / AFM / PNN building blocks, and
DCNv2's low-rank cross).

The JAX package's ``ops/interactions.py``: each takes a stacked field tensor
``e`` [B, F, D] (F embedded fields of width D) and is plain PyTorch. Pairs are
ordered (0,1), (0,2), ..., (F-2, F-1), the reference's double-loop order.
``low_rank_cross`` is not in the JAX package: it is DLRM-DCNv2's interaction
(``models/dlrm.py``), over the concatenated fields [B, F D].
"""

from __future__ import annotations

import torch


def fm_cross_term(e: torch.Tensor) -> torch.Tensor:
    """Scalar FM second-order term per row, sum_{i<j} <e_i, e_j>, by the
    sum-square identity 0.5 * sum_d[(sum_i e_id)^2 - sum_i e_id^2]:
    [B, F, D] -> [B]."""
    s = e.sum(dim=1)
    sq = (e * e).sum(dim=1)
    return 0.5 * (s * s - sq).sum(dim=-1)


def bi_interaction(e: torch.Tensor) -> torch.Tensor:
    """NFM's bi-interaction pooling, sum_{i<j} e_i * e_j: [B, F, D] -> [B, D]."""
    s = e.sum(dim=1)
    sq = (e * e).sum(dim=1)
    return 0.5 * (s * s - sq)


def _pair_indices(num_fields: int, device):
    idx = torch.triu_indices(num_fields, num_fields, offset=1, device=device)
    return idx[0], idx[1]


def pairwise_products(e: torch.Tensor) -> torch.Tensor:
    """AFM's cross products, all F(F-1)/2 of e_i * e_j: [B, F, D] -> [B, P, D]."""
    idx_i, idx_j = _pair_indices(e.shape[1], e.device)
    return e[:, idx_i, :] * e[:, idx_j, :]


def pairwise_inner_products(e: torch.Tensor) -> torch.Tensor:
    """PNN's inner products <e_i, e_j>, i < j: [B, F, D] -> [B, P]."""
    gram = torch.einsum("bfd,bgd->bfg", e, e)
    idx_i, idx_j = _pair_indices(e.shape[1], e.device)
    return gram[:, idx_i, idx_j]


def low_rank_cross(layers, x0: torch.Tensor) -> torch.Tensor:
    """DCNv2's low-rank cross network (Wang et al., arXiv:2008.13535, eq. 2 with
    W = U V; torchrec's ``LowRankCrossNet``) over x0 [B, d]: for each layer
    ``{"v": [d, r], "w": [r, d], "b": [d]}``,
    x_{l+1} = x0 * ((x_l v) w + b) + x_l, the bias inside the product with x0
    (DCN's ``models/dcn.py`` adds its bias outside it)."""
    x = x0
    for p in layers:
        x = x0 * ((x @ p["v"]) @ p["w"] + p["b"]) + x
    return x
