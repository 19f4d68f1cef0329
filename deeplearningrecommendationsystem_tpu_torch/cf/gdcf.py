"""GDCF: matrix factorisation by full-matrix gradient descent.

The JAX package's ``cf/gdcf.py`` on PyTorch (reference GDCF_Final.py:26-95):
raw factors P [U, d] and Q [d, I] drawn uniform in [0, 1), the mean
sigmoid cross-entropy over the full binary matrix, Adam (lr 0.01), 10
iterations, and each iteration's top-k recommendations from its pre-update
scores (the reference reuses its forward pass, GDCF_Final.py:53-75). The
top-k goes through ``ops/serving_topk.py::topk_scores`` (``scores_topk_kernel``
on the card): no item masked by default, as the reference recommends over
all items, the rated ones masked under ``exclude_rated``.

``jax.random.uniform`` cannot be replayed in torch: the initial factors come
from :func:`init_factors`, a CPU generator seeded with ``seed``, so a run on
the card and the same run on the CPU start from the same numbers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from deeplearningrecommendationsystem_tpu_torch.cf.neighborhood import as_matrix
from deeplearningrecommendationsystem_tpu_torch.ops.serving_topk import topk_scores


def init_factors(seed: int, num_users: int, num_items: int,
                 embedding_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P [U, d], Q [d, I]) float32, uniform in [0, 1), on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand((num_users, embedding_size), generator=gen),
            torch.rand((embedding_size, num_items), generator=gen))


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise ``-z log sigmoid(x) - (1 - z) log sigmoid(-x)``, the
    JAX package's (optax's) form."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def gdcf_train(
    matrix,
    embedding_size: int = 100,
    learning_rate: float = 0.01,
    iterations: int = 10,
    top_k: int = 50,
    seed: int = 0,
    exclude_rated: bool = False,
    device: str | torch.device = "cuda",
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Returns (history {"loss": [iters], "rec": [iters, U, k] int32}, final
    P @ Q), on ``device`` (CUDA by default)."""
    m = as_matrix(matrix, device)
    dev = m.device
    U, I = m.shape
    P, Q = (t.to(dev).requires_grad_(True)
            for t in init_factors(seed, U, I, embedding_size))
    opt = torch.optim.Adam([P, Q], lr=learning_rate)
    seen = (m > 0) if exclude_rated else torch.zeros(m.shape, dtype=torch.bool, device=dev)
    losses, recs = [], []
    for _ in range(iterations):
        opt.zero_grad(set_to_none=True)
        logits = P @ Q
        loss = sigmoid_bce(logits, m).mean()
        loss.backward()
        opt.step()
        _, rec = topk_scores(logits.detach(), seen, k=top_k)
        losses.append(loss.detach())
        recs.append(rec)
    with torch.no_grad():
        final = P @ Q
    return {"loss": torch.stack(losses), "rec": torch.stack(recs)}, final
