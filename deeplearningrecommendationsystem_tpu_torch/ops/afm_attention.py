"""AFM's attention pooling over pair products, forward and backward.

Ports the JAX package's ``ops/pallas/afm_attention.py``:
``afm_attention_pool_pallas`` (the forward) and the backward of
``afm_attention_pool_fused``, its custom VJP. Two public wrappers, each with
its plain PyTorch version beside it:

* ``afm_attention_pool(fields, att_w, att_b, att_h)``: fields [B, F, D] ->
  pooled [B, D], ``afm_attention(w, b, h, pairwise_products(fields))``;
* ``afm_attention_pool_bwd(fields, att_w, att_b, att_h, g)``: its gradients
  (d_fields, d_att_w, d_att_b, d_att_h) for the pooled cotangent g [B, D], in
  float32, as the Pallas backward returns them before its cast.

``AfmAttentionPool`` is the differentiable pool: its forward is the first
wrapper and its backward the second, cast to each input's dtype as
``_pool_bwd`` casts. The CUDA kernels keep the [B, P, D] pair products and
their [B, P, A] activations out of device memory in both directions; the
plain versions build them.

Dispatch is by device only: CPU tensors take the plain versions, CUDA
tensors launch the kernels (``ops/cuda/afm_attention.py``; float32, 6
fields, A <= 256) or raise.
"""

from __future__ import annotations

import torch

from deeplearningrecommendationsystem_tpu_torch.device import on_cpu as _on_cpu
from deeplearningrecommendationsystem_tpu_torch.ops.attention import afm_attention
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import afm_attention as _cuda
from deeplearningrecommendationsystem_tpu_torch.ops.interactions import pairwise_products


def afm_attention_pool_plain(fields, att_w, att_b, att_h):
    """Plain version of :func:`afm_attention_pool`."""
    return afm_attention(att_w, att_b, att_h, pairwise_products(fields))


def afm_attention_pool_bwd_plain(fields, att_w, att_b, att_h, g):
    """Plain version of :func:`afm_attention_pool_bwd`: autograd through the
    plain forward, in float32."""
    inputs = [t.detach().float().requires_grad_(True) for t in (fields, att_w, att_b, att_h)]
    with torch.enable_grad():
        out = afm_attention_pool_plain(*inputs)
        return torch.autograd.grad(out, inputs, g.float())


def afm_attention_pool(fields, att_w, att_b, att_h):
    """Pooled [B, D] of fields [B, F, D] under att_w [D, A], att_b [A], att_h [A, 1]."""
    if _on_cpu(fields, att_w, att_b, att_h):
        return afm_attention_pool_plain(fields, att_w, att_b, att_h)
    return _cuda.afm_attention_pool(fields, att_w, att_b, att_h)


def afm_attention_pool_bwd(fields, att_w, att_b, att_h, g):
    """(d_fields [B, F, D], d_att_w [D, A], d_att_b [A], d_att_h [A, 1]), float32."""
    if _on_cpu(fields, att_w, att_b, att_h, g):
        return afm_attention_pool_bwd_plain(fields, att_w, att_b, att_h, g)
    return _cuda.afm_attention_pool_bwd(fields, att_w, att_b, att_h, g)


class AfmAttentionPool(torch.autograd.Function):
    """The differentiable AFM pool: forward ``afm_attention_pool``, backward
    ``afm_attention_pool_bwd``."""

    @staticmethod
    def forward(ctx, fields, att_w, att_b, att_h):
        args = tuple(t.contiguous() for t in (fields, att_w, att_b, att_h))
        ctx.save_for_backward(*args)
        return afm_attention_pool(*args)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = afm_attention_pool_bwd(*saved, g.contiguous())
        return tuple(d.to(t.dtype) for d, t in zip(grads, saved))
