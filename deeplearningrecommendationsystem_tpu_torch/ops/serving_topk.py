"""Serving top-k: full-catalog scoring, seen mask and exact top-k.

Ports ``ops/pallas/serving_topk.py`` of the JAX package. Two public wrappers,
each with its plain PyTorch version beside it:

* ``topk_serve_matmul(P, Q, seen, k)``: for each user, ``s = P[u] . Q[i]``,
  set to ``NEG_INF`` where ``seen[u, i] != 0``, top k. The CUDA kernel keeps
  the [U, I] scores out of device memory.
* ``topk_scores(scores, seen, k)``: the same mask and top-k over a score
  matrix that is already computed.

Both return (values [U, k] float32, ids [U, k] int32), ordered by value
descending and, among equal values, by item index ascending: the first k of a
stable descending sort. When a user has fewer than k unseen items, the last
slots hold ``NEG_INF`` and the lowest-indexed seen items, as the sort gives.
(The JAX Pallas kernel repeats an id in those slots instead; its XLA path
agrees with the sort.)

Dispatch is by device only: a tensor on the CPU takes the plain version, a
tensor on CUDA launches the kernel (``ops/cuda/serving_topk.py``) or raises.
There is no fallback from CUDA to the plain path.

``topk_two_stage`` is pure XLA in JAX and plain torch here, on every device.
"""

from __future__ import annotations

import torch

from deeplearningrecommendationsystem_tpu_torch.device import on_cpu as _on_cpu
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as _cuda

NEG_INF = -1e30
MAX_K = _cuda.MAX_K  # top-k buffer width of the kernels


def stable_top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis; among equal
    values the lowest index comes first (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_serve_matmul_plain(P: torch.Tensor, Q: torch.Tensor, seen: torch.Tensor, k: int = 50):
    """Plain version of :func:`topk_serve_matmul`: matmul, mask, stable sort."""
    scores = torch.where(seen != 0, NEG_INF, P @ Q.T)
    vals, idx = stable_top_k(scores, k)
    return vals, idx.to(torch.int32)


def topk_scores_plain(scores: torch.Tensor, seen: torch.Tensor, k: int = 50):
    """Plain version of :func:`topk_scores`: mask, stable sort."""
    vals, idx = stable_top_k(torch.where(seen != 0, NEG_INF, scores), k)
    return vals, idx.to(torch.int32)


def topk_serve_matmul(P: torch.Tensor, Q: torch.Tensor, seen: torch.Tensor, k: int = 50):
    """(values [U, k], indices [U, k]) of the best unseen items per user.

    P [U, D] f32, Q [I, D] f32, seen [U, I] bool/int8/uint8 (nonzero = exclude).
    """
    if _on_cpu(P, Q, seen):
        return topk_serve_matmul_plain(P, Q, seen, k)
    return _cuda.topk_serve_matmul(P, Q, seen, k)


def topk_scores(scores: torch.Tensor, seen: torch.Tensor, k: int = 50):
    """Fused mask + top-k over a precomputed score matrix [U, I] f32."""
    if _on_cpu(scores, seen):
        return topk_scores_plain(scores, seen, k)
    return _cuda.topk_scores(scores, seen, k)


def topk_two_stage(P: torch.Tensor, Q: torch.Tensor, seen: torch.Tensor,
                   k: int = 50, group: int = 128):
    """Exact top-k for large catalogs via group-max dominance (plain torch).

    1. group maxes [U, I/group]: any group holding a true top-k item has
       max >= the kth value, and there are at most k such groups, so the
       top-k groups by max contain every top-k item;
    2. top-k of the k*group gathered candidates.

    Returns values identical to a full top-k of the masked scores; index
    order among equal values at the boundary may differ (ties are broken by
    group rank, then position), exactly as in the JAX version.
    """
    U = P.shape[0]
    I = Q.shape[0]
    scores = torch.where(seen != 0, NEG_INF, P @ Q.T)  # [U, I] one materialisation
    pad = (-I) % group
    if pad:
        scores = torch.cat([scores, scores.new_full((U, pad), NEG_INF)], dim=1)
    G = scores.shape[1] // group
    blocks = scores.view(U, G, group)
    gmax = blocks.amax(dim=-1)  # [U, G]
    kg = min(k, G)  # small catalogs may have fewer groups than k
    if kg * group < k:
        raise ValueError(f"k={k} exceeds candidate pool {kg}x{group}")
    _, gidx = stable_top_k(gmax, kg)  # [U, kg] winning groups
    cand = torch.gather(blocks, 1, gidx[:, :, None].expand(U, kg, group))
    vals, within = stable_top_k(cand.reshape(U, kg * group), k)
    g_of = torch.gather(gidx, 1, torch.div(within, group, rounding_mode="floor"))
    idx = g_of * group + within % group
    return vals, idx.to(torch.int32)
