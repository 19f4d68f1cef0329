"""Embedding-table row gather and its backward.

Ports three Pallas kernels of the JAX package, ``ops/pallas/gather.py``
(``gather_rows_pallas``), ``ops/pallas/gather_mm.py`` (``gather_mm_fwd_pallas``)
and ``ops/pallas/onehot_grad.py`` (``onehot_grad``). Two public wrappers, each
with its plain PyTorch version beside it:

* ``gather_rows_kernel(table, ids)``: ``table[ids]``, [B, D] in the table's
  dtype. Both TPU forwards compute this; the mask matmul of ``gather_mm.py``
  was the TPU's way round having no gather hardware.
* ``onehot_grad(ids, g, vocab)``: ``sum_n onehot(ids[n]) outer g[n]``, the
  [vocab, D] float32 table gradient (a scatter-add with f32 accumulation).

Ids follow JAX's ``table[ids]`` and its gradient: a negative id counts from
the end once (``id + V``); the gather then clamps to ``[0, V - 1]``, and the
gradient drops an id still outside ``[0, V)``. (The Pallas ``onehot_grad``
drops every negative id instead; in-range ids agree.)

Dispatch is by device only: CPU tensors take the plain version, CUDA tensors
launch the kernel (``ops/cuda/gather.py``) or raise.
"""

from __future__ import annotations

import torch

from deeplearningrecommendationsystem_tpu_torch.device import on_cpu as _on_cpu
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import gather as _cuda


def _wrapped(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    ids = ids.long()
    return torch.where(ids < 0, ids + vocab, ids)


def gather_rows_kernel_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_rows_kernel`."""
    V = table.shape[0]
    return table.index_select(0, _wrapped(ids, V).clamp(0, V - 1))


def onehot_grad_plain(ids: torch.Tensor, g: torch.Tensor, vocab: int) -> torch.Tensor:
    """Plain version of :func:`onehot_grad`: ``index_add_`` in float32."""
    idx = _wrapped(ids, vocab)
    keep = (idx >= 0) & (idx < vocab)
    out = torch.zeros((vocab, g.shape[1]), dtype=torch.float32, device=g.device)
    return out.index_add_(0, idx[keep], g[keep].float())


def gather_rows_kernel(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: table [V, D] f32/bf16, ids [B] int32/int64 -> [B, D]."""
    if _on_cpu(table, ids):
        return gather_rows_kernel_plain(table, ids)
    return _cuda.gather_rows(table, ids)


def onehot_grad(ids: torch.Tensor, g: torch.Tensor, vocab: int) -> torch.Tensor:
    """[vocab, D] float32 sums of the cotangent rows g [N, D] (f32/bf16) per id."""
    if _on_cpu(ids, g):
        return onehot_grad_plain(ids, g, vocab)
    return _cuda.onehot_grad(ids, g, vocab)
