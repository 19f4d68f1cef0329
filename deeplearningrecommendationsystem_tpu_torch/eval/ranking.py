"""Vectorised top-K ranking metrics (Precision/Recall/F1@k, MAP, NDCG, MRR).

The JAX package's ``eval/ranking.py`` on PyTorch. Membership of each
recommended item in the user's actual set is one ``gather`` on a scattered
[U, I] relevance bitmap, so the whole evaluation is a handful of device ops.

``reference_mode=True`` (default) reproduces the reference's formulas as
executed on its padded matrices, with its three quirks:

1. recall denominator: ``set()`` of each padded actual row counts the -1 pad
   marker as one extra relevant item for every user whose row is padded;
2. AP denominator: ``len(actual)`` of a padded row is the padded width, the
   same for every user;
3. NDCG ideal relevance: trailing -1 pads of the prediction row match the -1
   in the actual set and inflate the ideal gain; the pad count per user is
   ``n_seen[u] - min(n_seen)``.

``reference_mode=False`` computes the standard definitions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def ranking_metrics(
    actual: torch.Tensor,  # [U, La] item ids padded with -1
    rec_full: torch.Tensor,  # [U, I] full descending ranking (seen at tail)
    k: int,
    n_seen: Optional[torch.Tensor] = None,  # [U] seen counts, for quirk 3
    reference_mode: bool = True,
) -> Dict[str, torch.Tensor]:
    U, I = rec_full.shape
    La = actual.shape[1]
    dev = rec_full.device
    actual = actual.to(dev).long()

    # relevance bitmap: bitmap[u, i] = 1 iff item i in actual[u]
    safe = torch.where(actual >= 0, actual, I)  # park pads in an extra column
    bitmap = torch.zeros((U, I + 1), dtype=torch.float32, device=dev)
    bitmap.scatter_(1, safe, 1.0)
    bitmap = bitmap[:, :I]

    hits_full = torch.gather(bitmap, 1, rec_full.long())  # [U, I] 0/1
    hits_k = hits_full[:, :k]
    n_real = torch.sum(actual >= 0, dim=1).float()  # [U]
    has_pad = (n_real < La).float()

    # micro-averaged precision / recall / f1 @k
    same = torch.sum(hits_k)
    real_total = torch.sum(n_real) + (torch.sum(has_pad) if reference_mode else 0.0)
    precision = same / float(U * k)
    recall = same / real_total
    f1 = torch.where(precision + recall > 0,
                     2 * precision * recall / (precision + recall), 0.0)

    # MAP@k
    positions = torch.arange(1, k + 1, dtype=torch.float32, device=dev)
    prec_at = torch.cumsum(hits_k, dim=1) / positions
    ap_num = torch.sum(prec_at * hits_k, dim=1)  # [U]
    if reference_mode:
        ap = ap_num / La
    else:
        ap = torch.where(n_real > 0, ap_num / n_real.clamp_min(1.0), 0.0)
    map_score = torch.mean(ap)

    # NDCG@k with 2^rel - 1 gains; binary relevance makes the gain the relevance
    discounts = 1.0 / torch.log2(positions + 1.0)  # [k]
    dcg = torch.sum(hits_k * discounts, dim=1)
    if reference_mode:
        if n_seen is None:
            pads = torch.zeros((U,), dtype=torch.float32, device=dev)
        else:
            n_seen = n_seen.to(dev)
            pads = (n_seen - torch.min(n_seen)).float()
        ideal_ones = torch.clamp(n_real + has_pad * pads, max=float(k))
    else:
        ideal_ones = torch.clamp(n_real, max=float(k))
    disc_prefix = torch.cat([discounts.new_zeros(1), torch.cumsum(discounts, 0)])  # [k+1]
    idcg = disc_prefix[ideal_ones.long()]
    ndcg = torch.mean(torch.where(idcg > 0, dcg / idcg.clamp_min(1e-12), 0.0))

    # MRR over the full ranking (argmax returns the first maximum)
    first_hit = torch.argmax(hits_full, dim=1)
    any_hit = torch.any(hits_full > 0, dim=1)
    mrr = torch.mean(torch.where(any_hit, 1.0 / (first_hit + 1.0), 0.0))

    return {"precision": precision, "recall": recall, "f1": f1, "map": map_score,
            "ndcg": ndcg, "mrr": mrr}
