"""Classic neighbourhood collaborative filtering, vectorised.

The JAX package's ``cf/neighborhood.py`` on PyTorch (the reference's
UserCF_Final.py and ItemCF_Final.py):

* UserCF: binary implicit matrix from ``ua.base``; user-user cosine
  similarity; prediction = similarity-weighted neighbour ratings over the
  top-k neighbours, the similarity sum in the denominator counted for every
  neighbour, rated or not (UserCF_Final.py:30-42); top-n recommendations over
  unrated items; global Recall/Precision/F1 against ``ua.test``
  (UserCF_Final.py:67-93).
* ItemCF: the same pipeline with item-item cosine similarity and per-item
  neighbour aggregation (ItemCF_Final.py:24-39).

Every top-k goes through ``ops/serving_topk.py::topk_scores`` (the
``scores_topk_kernel`` on the card): the neighbours' with the identity as the
seen mask (JAX sets the diagonal to ``NEG_INF`` before ``lax.top_k``), the
recommendations' with ``matrix > 0`` (JAX: ``where(matrix > 0, NEG_INF,
pred)``). Both order as ``lax.top_k``: value descending, then index
ascending.

The recommenders take the matrix as an array or tensor and run on ``device``
(CUDA by default, which raises where there is none). ``user_cf_scores`` and
``item_cf_scores`` give the predictions the recommenders rank.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.ops.serving_topk import NEG_INF, topk_scores

__all__ = ["NEG_INF", "cf_eval", "item_cf_recommend", "item_cf_scores", "load_base_test",
           "user_cf_recommend", "user_cf_scores"]


def load_base_test(dataset_path: str, fold: str = "ua") -> Tuple[np.ndarray, List[list]]:
    """Load u?.base / u?.test -> (binary [U, I] float32 matrix, per-user test
    id lists). Ids are 0-based; the matrix covers the full 943 x 1682 grid."""
    base = np.loadtxt(os.path.join(dataset_path, f"{fold}.base"), dtype=np.int64)
    test = np.loadtxt(os.path.join(dataset_path, f"{fold}.test"), dtype=np.int64)
    num_users, num_items = 943, 1682
    m = np.zeros((num_users, num_items), dtype=np.float32)
    m[base[:, 0] - 1, base[:, 1] - 1] = 1.0
    per_user: List[list] = [[] for _ in range(num_users)]
    for u, i in zip(test[:, 0] - 1, test[:, 1] - 1):
        per_user[int(u)].append(int(i))
    return m, per_user


def _cosine(m: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt(torch.sum(m * m, dim=1, keepdim=True))
    normed = m / torch.clamp(norms, min=1e-12)
    return normed @ normed.T


def as_matrix(matrix, device: str | torch.device) -> torch.Tensor:
    """``matrix`` (a NumPy array or a tensor) as a float32 tensor on ``device``."""
    return torch.as_tensor(matrix, dtype=torch.float32, device=resolve_device(device))


def _neighbours(sim: torch.Tensor, k: int):
    """(weights, ids) of each row's k most similar others."""
    self_mask = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
    w, idx = topk_scores(sim.contiguous(), self_mask, k=k)
    return w, idx.long()


def _normalised(pred: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    nonzero = denom != 0
    return torch.where(nonzero, pred / torch.where(nonzero, denom, 1.0), 0.0)


def _unrated_top_n(matrix: torch.Tensor, pred: torch.Tensor, top_n: int) -> torch.Tensor:
    _, rec = topk_scores(pred.contiguous(), matrix > 0, k=top_n)
    return rec


def user_cf_scores(matrix, k_neighbors: int = 10,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """UserCF's predictions [U, I] (before the rated items are masked)."""
    m = as_matrix(matrix, device)
    w, idx = _neighbours(_cosine(m), k_neighbors)  # [U, k]
    pred = torch.einsum("uk,uki->ui", w, m[idx])  # m[idx]: [U, k, I]
    return _normalised(pred, torch.sum(w, dim=1, keepdim=True))  # every neighbour counts


def item_cf_scores(matrix, k_neighbors: int = 10,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """ItemCF's predictions [U, I] (before the rated items are masked):
    ``pred[u, i] = sum_k w[i, k] * m[u, idx[i, k]] / sum_k w[i, k]``."""
    m = as_matrix(matrix, device)
    w, idx = _neighbours(_cosine(m.T), k_neighbors)  # [I, k] neighbours per item
    pred = torch.einsum("ik,uik->ui", w, m[:, idx])  # m[:, idx]: [U, I, k]
    return _normalised(pred, torch.sum(w, dim=1))


def user_cf_recommend(matrix, k_neighbors: int = 10, top_n: int = 20,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Top-n unrated item ids per user ([U, top_n] int32, on ``device``)."""
    m = as_matrix(matrix, device)
    return _unrated_top_n(m, user_cf_scores(m, k_neighbors, m.device), top_n)


def item_cf_recommend(matrix, k_neighbors: int = 10, top_n: int = 20,
                      device: str | torch.device = "cuda") -> torch.Tensor:
    """Top-n unrated item ids per user via item-item similarity ([U, top_n]
    int32, on ``device``)."""
    m = as_matrix(matrix, device)
    return _unrated_top_n(m, item_cf_scores(m, k_neighbors, m.device), top_n)


def cf_eval(rec: np.ndarray, test_lists: list) -> Tuple[float, float, float]:
    """Global Recall / Precision / F1 averaged over users.

    The reference's accumulation (UserCF_Final.py:67-93): recall contributes
    0 for users with no test items; precision divides by the recommendation
    list's length; both average over ALL users.
    """
    rec = np.asarray(rec)
    num_users = rec.shape[0]
    recall = precision = 0.0
    for u in range(num_users):
        same = len(set(rec[u].tolist()) & set(test_lists[u]))
        if test_lists[u]:
            recall += same / len(test_lists[u])
        precision += same / rec.shape[1]
    recall /= num_users
    precision /= num_users
    f1 = 2 * recall * precision / (recall + precision) if recall + precision else 0.0
    return recall, precision, f1
