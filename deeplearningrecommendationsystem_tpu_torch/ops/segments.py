"""Rows grouped by id: the index preparation of the fused full-batch trainers.

``id_segments(ids, V)`` gives a stable order of the rows by id and the
offsets of each id's segment in it: the rows of id ``v`` are
``order[offsets[v]:offsets[v + 1]]``, in row order. An id outside ``[0, V)``
is left out of every segment: its rows sit, in row order, before
``offsets[0]`` (ids below 0) or from ``offsets[V]`` on (ids of V or more).
The trainers (``ops/cuda/{mf_epoch,lr_epoch}.py``) build these once a call,
since the ids do not change across epochs, and sum each table row's gradient
over its segment in this fixed order.

Plain tensor code on the ids' device: a stable sort of the ids clipped to
``[-1, V]`` in the narrowest integer type that holds them (int16 below 32,767:
a radix sort then makes two passes, not four or eight) and a binary search of
the segment starts, with no host synchronisation.
"""

from __future__ import annotations

import torch


def id_segments(ids: torch.Tensor, V: int):
    """ids [B] int32/int64, V >= 1 -> (order [B] int64, offsets [V + 1] int64)."""
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids: [B] int32 or int64, got {tuple(ids.shape)} {ids.dtype}")
    if V < 1:
        raise ValueError(f"V={V} must be >= 1")
    key = ids.clamp(-1, V).to(torch.int16 if V < 2**15 - 1 else ids.dtype)
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.arange(V + 1, dtype=key.dtype, device=ids.device)
    return order, torch.searchsorted(sorted_key, starts)
