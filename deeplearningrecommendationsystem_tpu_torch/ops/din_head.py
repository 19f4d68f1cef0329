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
  ``din_head_fwd(hist_e, target_e, weights)`` -> logits [B] in the inputs'
  dtype, and ``din_head_bwd(hist_e, target_e, weights, g)`` -> (d hist
  [B, L, D], d target [B, D], the 14 weight gradients), float32 as the Pallas
  backward writes them before its cast;
* ``DinHead``, the differentiable head: its forward is the first wrapper and
  its backward the second, cast to each input's dtype as ``_din_head_bwd``
  casts.

The structure is the kernel's: two hidden layers in each net, attention
3D -> A1 -> A2 -> 1 and fc 2D -> F1 -> F2 -> 1 (reference model/din.py:14-29).
``kernel_route`` says from the shapes whether a model takes this head.
Dispatch is by device only: CPU tensors take the plain versions, CUDA
tensors launch the kernels (``ops/cuda/din_head.py``) or raise.

Precision follows the JAX kernel on float32 and on bfloat16 inputs alike (one
dtype for all 16 inputs): every product takes its operands in the weights'
dtype with float32 accumulation (``_mdot``, ``_cdot``); z, the relus, the
softmax weights, the pooled vector, the biases and every sum stay float32.
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


def kernel_route(att: Layers, fc: Layers, L: int, D: int) -> bool:
    """Whether the DIN kernels (this head and the window pool,
    ``ops/din_attention.py``) take nets ``att``, ``fc`` at history length L
    and embedding width D. True only for two hidden layers in each net ending
    in one unit, biases on the attention net's hidden layers, L at most
    ``MAX_HISTORY``, D, A1, A2, F1, F2 multiples of 4 with F at most
    ``MAX_FC``, and widths at which a tile of every launch the route sends (the
    head's forward, its backward in both dtypes: float32's tile walk and the
    bf16 split, the window pool) fits a block's shared memory
    (``ops/cuda/din_head.py::fits``: at L 64 and the preset's nets, D up to
    360). Otherwise DIN takes the composition ``attention_pool`` + ``mlp``,
    the JAX DIN's default route. Decided from shapes alone, before any
    launch."""
    if len(att) != 3 or len(fc) != 3 or any("b" not in layer for layer in att[:2]):
        return False
    A1, A2 = att[0]["w"].shape[1], att[1]["w"].shape[1]
    F1, F2 = fc[0]["w"].shape[1], fc[1]["w"].shape[1]
    if att[2]["w"].shape[1] != 1 or fc[2]["w"].shape[1] != 1:
        return False
    every = _cuda.FWD | _cuda.BWD | _cuda.POOL | _cuda.SPLIT_BF16
    return max(F1, F2) <= _cuda.MAX_FC and _cuda.fits(L, D, A1, A2, F1, F2) & every == every


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


def _mdot(a, b):
    """``a @ b`` with ``a`` cast to ``b``'s dtype, in float32: the JAX kernel's
    ``_mdot`` (operands in the weights' dtype, float32 accumulation)."""
    return a.to(b.dtype).float() @ b.float()


def _cdot(a, b, dtype):
    """``a^T @ b`` over the rows, both operands cast to ``dtype``, in float32:
    the JAX kernel's ``_cdot`` (a weight gradient)."""
    return a.to(dtype).float().T @ b.to(dtype).float()


def _forward(hist_e, target_e, weights):
    """The forward's intermediates, float32, positions flattened to rows:
    (z1, z2 [B L, A], w [B, L], pooled [B, D], f1, f2 [B, F], logit [B, 1])."""
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = weights
    B, L, D = hist_e.shape
    h = hist_e.reshape(B * L, D)
    t_term = _mdot(target_e, wt) + b1.float()  # [B, A1]
    z1 = _mdot(h, wh) + t_term.repeat_interleave(L, dim=0)
    z2 = _mdot(torch.relu(z1), w2) + b2.float()
    scores = (_mdot(torch.relu(z2), w3) + b3.float()).reshape(B, L)
    w = torch.softmax(scores, dim=-1)
    pooled = torch.einsum("bl,bld->bd", w, hist_e.float())
    f1 = torch.relu(_mdot(pooled, u1p) + _mdot(target_e, u1t) + c1.float())
    f2 = torch.relu(_mdot(f1, u2) + c2.float())
    return z1, z2, w, pooled, f1, f2, _mdot(f2, u3) + c3.float()


def din_head_fwd_plain(hist_e, target_e, weights):
    """Plain version of :func:`din_head_fwd`: ``attention_pool`` + ``mlp`` on the
    decomposed weights, in the kernel's order of operations and its precision.
    The products take their operands in the weights' dtype (``_mdot``); sums,
    relus, the softmax and the pool are float32; the logits come out in
    ``hist_e``'s dtype."""
    return _forward(hist_e, target_e, weights)[-1][:, 0].to(hist_e.dtype)


def din_head_bwd_plain(hist_e, target_e, weights, g):
    """Plain version of :func:`din_head_bwd`: the JAX kernel's backward written
    out (``_bwd_kernel``), float32 gradients. Each product's operands are cast
    to the weights' dtype (``_mdot``, ``_cdot``); the relu masks, the softmax's
    backward, the bias sums and every accumulation stay float32."""
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = weights
    dt = wh.dtype
    B, L, D = hist_e.shape
    z1, z2, w, pooled, f1, f2, _ = _forward(hist_e, target_e, weights)
    h, t = hist_e.reshape(B * L, D), target_e
    gf = g.float()[:, None]  # [B, 1]
    # the fc head
    du3, dc3 = _cdot(f2, gf, dt), gf.sum(0, keepdim=True)
    dzf2 = _mdot(gf, u3.T) * (f2 > 0)
    du2, dc2 = _cdot(f1, dzf2, dt), dzf2.sum(0, keepdim=True)
    dzf1 = _mdot(dzf2, u2.T) * (f1 > 0)
    du1p, du1t, dc1 = _cdot(pooled, dzf1, dt), _cdot(t, dzf1, dt), dzf1.sum(0, keepdim=True)
    dpooled, dtgt = _mdot(dzf1, u1p.T), _mdot(dzf1, u1t.T)
    # the softmax: ds_l = w_l (dpooled . h_l - sum_k w_k dpooled . h_k)
    dw_cols = torch.einsum("bd,bld->bl", dpooled, hist_e.float())
    ds = (w * (dw_cols - (w * dw_cols).sum(-1, keepdim=True))).reshape(B * L, 1)
    # the activation unit
    dz2 = _mdot(ds, w3.T) * (z2 > 0)
    dw3, db3 = _cdot(torch.relu(z2), ds, dt), ds.sum(0, keepdim=True)
    dw2, db2 = _cdot(torch.relu(z1), dz2, dt), dz2.sum(0, keepdim=True)
    dz1 = _mdot(dz2, w2.T) * (z1 > 0)
    dwh, db1 = _cdot(h, dz1, dt), dz1.sum(0, keepdim=True)
    dz1_rows = dz1.reshape(B, L, -1).sum(1)  # [B, A1]
    dwt = _cdot(t, dz1_rows, dt)
    dtgt = dtgt + _mdot(dz1_rows, wt.T)
    dhist = w[..., None] * dpooled[:, None, :] + _mdot(dz1, wh.T).reshape(B, L, D)
    return (dhist, dtgt, dwh, dwt, db1, dw2, db2, dw3, db3,
            du1p, du1t, dc1, du2, dc2, du3, dc3)


def din_head_fwd(hist_e, target_e, weights):
    """Logits [B] of hist_e [B, L, D] and target_e [B, D] under the 14 weights."""
    if _on_cpu(hist_e, target_e, *weights):
        return din_head_fwd_plain(hist_e, target_e, weights)
    return _cuda.din_head_fused(hist_e, target_e, weights)


def din_head_bwd(hist_e, target_e, weights, g, pooled=None):
    """(d hist_e, d target_e, d wh, ..., d c3) for the logit cotangent g [B],
    float32. On the card, ``pooled`` (the forward's pooled rows, from
    ``ops/cuda/din_head.py::din_head_fused_pooled``) saves the backward a
    launch in either dtype; the plain version recomputes everything."""
    if _on_cpu(hist_e, target_e, *weights, g):
        return din_head_bwd_plain(hist_e, target_e, weights, g)
    return _cuda.din_head_fused_bwd(hist_e, target_e, weights, g, pooled)


class DinHead(torch.autograd.Function):
    """The differentiable DIN head: forward ``din_head_fwd``, backward
    ``din_head_bwd``; ``apply(hist_e, target_e, *weights)``. On the card the
    forward's pooled rows, where it has them, go to the backward."""

    @staticmethod
    def forward(ctx, hist_e, target_e, *weights):
        args = tuple(t.contiguous() for t in (hist_e, target_e, *weights))
        ctx.save_for_backward(*args)
        ctx.pooled = None
        if _on_cpu(*args):
            return din_head_fwd(args[0], args[1], args[2:])
        out, ctx.pooled = _cuda.din_head_fused_pooled(args[0], args[1], args[2:])
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        args = (saved[0], saved[1], saved[2:], g.contiguous())
        grads = din_head_bwd(*args) if ctx.pooled is None else din_head_bwd(*args, pooled=ctx.pooled)
        return tuple(d.to(t.dtype) for d, t in zip(grads, saved))


def din_head(att: Layers, fc: Layers, hist_e: torch.Tensor,
             target_e: torch.Tensor) -> torch.Tensor:
    """Differentiable logits [B]: ``din_head_fused``'s counterpart. Where no
    backward can follow (grad mode off, or no input needs a gradient), the
    forward alone, which keeps no pooled rows."""
    weights = din_head_weights(att, fc, hist_e.shape[-1])
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (hist_e, target_e, *weights))):
        return din_head_fwd(hist_e.contiguous(), target_e.contiguous(),
                            tuple(w.contiguous() for w in weights))
    return DinHead.apply(hist_e, target_e, *weights)
