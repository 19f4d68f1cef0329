"""DIN's activation unit, softmax and pool, forward only: the window catalog
scorer's attention.

Ports the JAX package's ``ops/pallas/din_attention.py::
din_attention_pool_pallas``. One public wrapper with its plain PyTorch version
beside it:

* ``din_attention_pool(hist_e, target_e, att)``: hist_e [B, L, D], target_e
  [B, D] and the attention MLP ``att`` (3D -> A1 -> A2 -> 1) -> pooled [B, D],
  ``attention_pool(att, hist_e, target_e)`` with no mask.

The kernel drops the last layer's bias, which shifts every score of a row
alike and cancels in the softmax (``din_attention.py:30-32``); the plain
version keeps it, so the two agree to rounding, not bit for bit.

Dispatch is by device only: CPU tensors take the plain version, CUDA tensors
launch the kernel (``ops/cuda/din_attention.py``; float32, L <= 64) or raise.
"""

from __future__ import annotations

from deeplearningrecommendationsystem_tpu_torch.device import on_cpu as _on_cpu
from deeplearningrecommendationsystem_tpu_torch.ops.attention import attention_pool
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_attention as _cuda


def din_attention_pool_plain(hist_e, target_e, att):
    """Plain version of :func:`din_attention_pool`."""
    return attention_pool(att, hist_e, target_e)


def din_attention_pool(hist_e, target_e, att):
    """Pooled [B, D] of hist_e [B, L, D] against target_e [B, D] under ``att``."""
    if _on_cpu(hist_e, target_e, *(t for layer in att for t in layer.values())):
        return din_attention_pool_plain(hist_e, target_e, att)
    return _cuda.din_attention_pool(hist_e, target_e, att)
