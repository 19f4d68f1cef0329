"""Pointwise classification metrics on the caller's device.

The JAX package's ``eval/pointwise.py`` on PyTorch, reproducing the reference
evaluator (evaluator/evaluator.py:13-20): predictions are thresholded at 0.5,
then accuracy / precision / recall / F1 / "AUC". Quirk kept for parity: the
reference feeds the *binarised* predictions to ``roc_auc_score``, so its "AUC"
is (TPR + TNR) / 2 -- balanced accuracy -- not a ranking AUC. ``auc_raw`` is
the true rank-based AUC on raw scores (weighted, tie-corrected).

Every metric takes an optional weight vector (the masked-matrix mode). The
results are 0-d tensors on the inputs' device: nothing here waits for the
device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(b > 0, a / torch.where(b > 0, b, 1.0), 0.0)


def true_auc(y_true: torch.Tensor, scores: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted, tie-corrected probability that a positive outranks a negative.

    AUC = sum_pos [ W_neg(score < s) + 0.5 * W_neg(score = s) ] / (W_pos * W_neg),
    with one sort and two ``searchsorted`` passes.
    """
    y = y_true.float().reshape(-1)
    s = scores.float().reshape(-1)
    w = torch.ones_like(y) if weights is None else weights.float().reshape(-1)
    s_sorted, order = torch.sort(s, stable=True)
    negw_sorted = (w * (1.0 - y))[order]
    prefix = torch.cat([negw_sorted.new_zeros(1), torch.cumsum(negw_sorted, 0)])  # [n+1]
    left = torch.searchsorted(s_sorted, s, side="left")
    right = torch.searchsorted(s_sorted, s, side="right")
    w_less = prefix[left]
    w_eq = prefix[right] - w_less
    pos_mass = torch.sum(w * y * (w_less + 0.5 * w_eq))
    w_pos = torch.sum(w * y)
    w_neg = torch.sum(w * (1.0 - y))
    return _safe_div(pos_mass, w_pos * w_neg)


def pointwise_metrics(
    y_true: torch.Tensor,
    probs: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    threshold: float = 0.5,
    include_auc_raw: bool = True,
) -> Dict[str, torch.Tensor]:
    """accuracy / precision / recall / f1 / auc (reference definition) / auc_raw.

    ``include_auc_raw=False`` skips the sort-based true AUC; the trainer takes
    it once, on the final params.
    """
    y = y_true.float().reshape(-1)
    p = probs.float().reshape(-1)
    w = torch.ones_like(y) if weights is None else weights.float().reshape(-1)
    pred = (p >= threshold).float()

    tp = torch.sum(w * pred * y)
    fp = torch.sum(w * pred * (1.0 - y))
    fn = torch.sum(w * (1.0 - pred) * y)
    tn = torch.sum(w * (1.0 - pred) * (1.0 - y))

    accuracy = _safe_div(tp + tn, tp + tn + fp + fn)
    precision = _safe_div(tp, tp + fp)
    recall = _safe_div(tp, tp + fn)
    f1 = _safe_div(2.0 * precision * recall, precision + recall)
    tnr = _safe_div(tn, tn + fp)
    out = {
        "accuracy": accuracy,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "auc": 0.5 * (recall + tnr),  # == roc_auc_score on binarised predictions
    }
    if include_auc_raw:
        out["auc_raw"] = true_auc(y, p, w)
    return out
