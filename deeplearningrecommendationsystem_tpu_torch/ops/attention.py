"""Attention pooling (the JAX package's ``ops/attention.py``).

``afm_attention`` is AFM's attention over pair products, in plain PyTorch: the
oracle of the AFM pooling kernel (``ops/afm_attention.py``). DIN's activation
unit (``din_attention_weights``, ``attention_pool``) comes with the DIN slice.
"""

from __future__ import annotations

import torch


def afm_attention(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                  cross: torch.Tensor) -> torch.Tensor:
    """AFM attention-weighted sum of pair products: relu(cross @ W + b) @ h,
    softmax over the pairs, weighted sum (reference model/afm.py:63-65).
    w [D, A], b [A], h [A, 1], cross [B, P, D] -> [B, D]."""
    scores = torch.relu(cross @ w + b) @ h  # [B, P, 1]
    weights = torch.softmax(scores, dim=1)
    return (weights * cross).sum(dim=1)
