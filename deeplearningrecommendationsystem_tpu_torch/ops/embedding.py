"""Id-table lookup with a kernel in both directions.

Ports the dense branch of the JAX package's ``parallel/ep.py::gather_rows``
and the routes it chooses among: the native ``table[ids]``,
``ops/embedding.py::gather_matmul_bwd`` and ``gather_onehot``, and the Pallas
pair ``ops/pallas/gather_mm.py::gather_rows_mm_pallas``. On the TPU those
routes were different lowerings of one function, picked by speed; here
``gather_rows`` is all of them, through :class:`GatherRows`: the forward is
the gather kernel and the backward the ``onehot_grad`` kernel
(``ops/gather.py``), cast to the table's dtype as ``gather_mm.py::_gmp_bwd``
casts it. On CPU tensors both run their plain versions.

Out-of-range ids take ``table[ids]``'s semantics on every route (see
``ops/gather.py``); the JAX one-hot routes give a zero row instead, and no
shipped caller passes such ids.

Row-sharded (EP) tables over a mesh are not ported yet (``ROADMAP.md`` §1
item 13): ``gather_rows(..., mesh=...)`` raises.
"""

from __future__ import annotations

import torch

from deeplearningrecommendationsystem_tpu_torch.ops.gather import gather_rows_kernel, onehot_grad


class GatherRows(torch.autograd.Function):
    """``table[ids]`` for ids [N]; the table's gradient is ``onehot_grad``."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        return gather_rows_kernel(table.contiguous(), ids)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (ids,) = ctx.saved_tensors
        return onehot_grad(ids, g.contiguous(), ctx.vocab).to(ctx.dtype), None


def gather_rows(table: torch.Tensor, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """``table[ids]`` for ids of any shape -> ids.shape + (D,)."""
    if mesh is not None:
        raise NotImplementedError(
            "row-sharded (EP) tables are not ported yet; see ROADMAP.md §1 item 13")
    out = GatherRows.apply(table, ids.reshape(-1).contiguous())
    return out.reshape(*ids.shape, table.shape[1])
