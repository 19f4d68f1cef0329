"""The fused DIN head, forward and backward: activation unit, softmax, pool and
the final MLP, from embedded history and target to logits.

Ports the JAX package's ``ops/pallas/din_head.py::din_head_fused``: its
forward (``_fwd_kernel``) and its custom VJP's backward (``_bwd_kernel``).
Three parts, as there:

* ``din_head_weights(att, fc, D)``: the 14 kernel weights of ``_weights_tuple``
  -- wh = W1_h + W1_(h-t), wt = W1_t - W1_(h-t), the fc's first layer split
  into its pooled and target halves, every bias as a [1, n] row. Plain torch
  ops outside the autograd Function, as JAX keeps them outside ``custom_vjp``,
  so autograd maps the kernel's dwh, dwt, du1p and du1t back onto
  ``att.0.w`` [3D, A1] and ``fc.0.w`` [2D, F1];
* two public wrappers, each with its plain PyTorch version beside it:
  ``din_head_fwd(hist_e, target_e, weights)`` -> logits [B], and
  ``din_head_bwd(hist_e, target_e, weights, g)`` -> (d hist [B, L, D],
  d target [B, D], the 14 weight gradients), float32 as the Pallas backward
  writes them before its cast;
* ``DinHead``, the differentiable head: its forward is the first wrapper and
  its backward the second, cast to each input's dtype as ``_din_head_bwd``
  casts.

The structure is the kernel's: two hidden layers in each net, attention
3D -> A1 -> A2 -> 1 and fc 2D -> F1 -> F2 -> 1 (reference model/din.py:14-29).
Dispatch is by device only: CPU tensors take the plain versions, CUDA
tensors launch the kernels (``ops/cuda/din_head.py``; float32) or raise.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch

from deeplearningrecommendationsystem_tpu_torch.device import on_cpu as _on_cpu
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as _cuda

Layers = Sequence[Mapping[str, torch.Tensor]]
# names of the 14 weights, in the kernel's order
WEIGHT_NAMES = ("wh", "wt", "b1", "w2", "b2", "w3", "b3",
                "u1p", "u1t", "c1", "u2", "c2", "u3", "c3")


def din_head_weights(att: Layers, fc: Layers, D: int) -> Tuple[torch.Tensor, ...]:
    """The 14 kernel weights from the two MLPs' params (``_weights_tuple``)."""
    if len(att) != 3 or len(fc) != 3:
        raise ValueError("the DIN head kernel takes two hidden layers in each net")
    w1, u1 = att[0]["w"], fc[0]["w"]
    if w1.shape[0] != 3 * D or u1.shape[0] != 2 * D:
        raise ValueError(f"first layers {tuple(w1.shape)}, {tuple(u1.shape)} do not take "
                         f"[h, h-t, t] and [pooled, t] at D = {D}")

    def row(layer, n):
        b = layer.get("b")
        return b.reshape(1, n) if b is not None else torch.zeros((1, n), dtype=w1.dtype,
                                                                 device=w1.device)

    return (
        w1[:D] + w1[D:2 * D], w1[2 * D:] - w1[D:2 * D], row(att[0], w1.shape[1]),
        att[1]["w"], row(att[1], att[1]["w"].shape[1]),
        att[2]["w"], row(att[2], 1),
        u1[:D], u1[D:], row(fc[0], u1.shape[1]),
        fc[1]["w"], row(fc[1], fc[1]["w"].shape[1]),
        fc[2]["w"], row(fc[2], 1),
    )


def din_head_fwd_plain(hist_e, target_e, weights):
    """Plain version of :func:`din_head_fwd`: ``attention_pool`` + ``mlp`` on the
    decomposed weights, in the kernel's order of operations."""
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = weights
    z1 = hist_e @ wh + (target_e @ wt + b1)[:, None, :]
    scores = (torch.relu(torch.relu(z1) @ w2 + b2) @ w3 + b3)[..., 0]  # [B, L]
    w = torch.softmax(scores, dim=-1)
    pooled = torch.einsum("bl,bld->bd", w, hist_e)
    f1 = torch.relu(pooled @ u1p + target_e @ u1t + c1)
    f2 = torch.relu(f1 @ u2 + c2)
    return (f2 @ u3 + c3)[:, 0]


def din_head_bwd_plain(hist_e, target_e, weights, g):
    """Plain version of :func:`din_head_bwd`: autograd through the plain
    forward, in float32."""
    inputs = [t.detach().float().requires_grad_(True) for t in (hist_e, target_e, *weights)]
    with torch.enable_grad():
        out = din_head_fwd_plain(inputs[0], inputs[1], inputs[2:])
        return torch.autograd.grad(out, inputs, g.float())


def din_head_fwd(hist_e, target_e, weights):
    """Logits [B] of hist_e [B, L, D] and target_e [B, D] under the 14 weights."""
    if _on_cpu(hist_e, target_e, *weights):
        return din_head_fwd_plain(hist_e, target_e, weights)
    return _cuda.din_head_fused(hist_e, target_e, weights)


def din_head_bwd(hist_e, target_e, weights, g):
    """(d hist_e, d target_e, d wh, ..., d c3) for the logit cotangent g [B], float32."""
    if _on_cpu(hist_e, target_e, *weights, g):
        return din_head_bwd_plain(hist_e, target_e, weights, g)
    return _cuda.din_head_fused_bwd(hist_e, target_e, weights, g)


class DinHead(torch.autograd.Function):
    """The differentiable DIN head: forward ``din_head_fwd``, backward
    ``din_head_bwd``; ``apply(hist_e, target_e, *weights)``."""

    @staticmethod
    def forward(ctx, hist_e, target_e, *weights):
        args = tuple(t.contiguous() for t in (hist_e, target_e, *weights))
        ctx.save_for_backward(*args)
        return din_head_fwd(args[0], args[1], args[2:])

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = din_head_bwd(saved[0], saved[1], saved[2:], g.contiguous())
        return tuple(d.to(t.dtype) for d, t in zip(grads, saved))


def din_head(att: Layers, fc: Layers, hist_e: torch.Tensor,
             target_e: torch.Tensor) -> torch.Tensor:
    """Differentiable logits [B]: ``din_head_fused``'s counterpart."""
    return DinHead.apply(hist_e, target_e, *din_head_weights(att, fc, hist_e.shape[-1]))
