"""Attention pooling (the JAX package's ``ops/attention.py``), in plain PyTorch.

``afm_attention`` is AFM's attention over pair products: the oracle of the AFM
pooling kernel (``ops/afm_attention.py``).

``din_attention_weights`` and ``attention_pool`` are DIN's activation unit:
an MLP over [hist, hist - target, target] scores each history item against
the target, softmax-normalised over the history axis (reference
model/din.py:14-20,39-44). Unmasked, ``attention_pool`` is the oracle of the
DIN pool kernel (``ops/din_attention.py``) and, with ``mlp``, of the fused DIN
head (``ops/din_head.py``). With a mask it is the route itself: no kernel
takes a mask, as the JAX package sends masked attention through XLA.

Parity note: the reference does NOT mask left-padding (item id 0 is a real
item, scripts/din.py:20-31); ``mask`` is the optional extension.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp


def afm_attention(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
                  cross: torch.Tensor) -> torch.Tensor:
    """AFM attention-weighted sum of pair products: relu(cross @ W + b) @ h,
    softmax over the pairs, weighted sum (reference model/afm.py:63-65).
    w [D, A], b [A], h [A, 1], cross [B, P, D] -> [B, D]."""
    scores = torch.relu(cross @ w + b) @ h  # [B, P, 1]
    weights = torch.softmax(scores, dim=1)
    return (weights * cross).sum(dim=1)


def din_attention_weights(att_mlp: Sequence[Mapping[str, torch.Tensor]],
                          hist_embed: torch.Tensor, target_embed: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention weights [B, L] of hist [B, L, D] against target [B, D].

    The first layer over concat([h, h - t, t]) is decomposed: with W1's three
    D-row blocks, concat @ W1 = h @ (W1_a + W1_b) + t @ (W1_c - W1_b), so the
    [B, L, 3D] concat is never built. ``mask`` [B, L] bool (True = valid)
    gives masked positions the score -1e9.
    """
    D = hist_embed.shape[-1]
    w1, b1 = att_mlp[0]["w"], att_mlp[0].get("b")
    if w1.shape[0] != 3 * D:
        raise ValueError("attention layer 1 must take [h, h-t, t]")
    wh = w1[:D] + w1[D:2 * D]
    wt = w1[2 * D:] - w1[D:2 * D]
    x1 = hist_embed @ wh + (target_embed @ wt)[:, None, :]
    if b1 is not None:
        x1 = x1 + b1
    scores = mlp(att_mlp[1:], torch.relu(x1))[..., 0]  # [B, L]
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e9))
    return softmax(scores)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis. Under bf16 it is ``jax.nn.softmax``'s own
    lowering: ``exp(x - max)`` rounded to bf16, its sum in float32 rounded to
    bf16, then the quotient (``torch.softmax`` rounds once, and so lands about
    a third of the weights an ulp from the JAX package's); in float32,
    ``torch.softmax``."""
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.float().sum(dim=-1, keepdim=True).to(x.dtype)


def attention_pool(att_mlp: Sequence[Mapping[str, torch.Tensor]], hist_embed: torch.Tensor,
                   target_embed: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DIN's pooled user interest: the attention-weighted sum over the history, [B, D]."""
    w = din_attention_weights(att_mlp, hist_embed, target_embed, mask)
    return torch.einsum("bl,bld->bd", w, hist_embed)
