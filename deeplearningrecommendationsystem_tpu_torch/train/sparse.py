"""Sparse (lazy) embedding-row optimizer updates for production-scale tables.

The JAX package's ``train/sparse.py`` on PyTorch. A dense Adam step reads and
writes the whole table and both moment buffers every minibatch, so its cost
grows with the vocabulary; a step here touches only the rows the batch
references.

* :func:`dedup_rows` -- the batch's ids, deduplicated and sorted, padded to
  ``[B]`` with ``vocab`` as the sentinel, and the per-example row gradients
  summed per id (the exact gradient of a gather, on the touched rows).
* :func:`rowwise_adagrad` -- DLRM's embedding optimizer: one accumulator
  scalar per row, updated and applied only on touched rows.
* :func:`lazy_adam` -- Adam whose moments advance only for touched rows, with
  the global step's bias correction, ``m_hat / (sqrt(v_hat) + eps)`` as the
  JAX package writes it (not ``torch.optim.SparseAdam``, which places
  ``eps`` after the bias corrections are folded into the step size).

On the CPU, and for any dtype the kernels do not take, plain tensor code, as
the JAX package leaves it to XLA (``dedup_rows_plain``,
``rowwise_adagrad_plain``). It is sync-free: every shape is ``[B]`` whatever
the number of distinct ids, so a step is queued without waiting for the
device. ``torch.unique`` would wait (its output size is dynamic); the ids are
grouped by a stable sort, boundary flags and a cumulative sum instead.
Duplicate gradients are summed by an op that is deterministic on each device:
``index_put_(accumulate=True)`` on CUDA (a sort-based kernel; ``index_add_``
there adds with atomics in a varying order), ``index_add_`` on the CPU
(serial, in row order; ``index_put_`` there adds with atomics across
threads). A run gives the same bits every time.

JAX turns the padding slots into no-ops with ``mode="fill"`` gathers and
``mode="drop"`` scatters. Torch has neither: a padding slot here reads the
last table row and writes, to the same row as the last real slot, that
slot's own new values, so the write of every slot lands on a touched row with
the value JAX writes there and every other row, row ``V - 1`` included, keeps
its bits (:func:`_write_slots`).

CUDA float32 rows (ids int32 or int64, ``vocab + 1 < 2**31``) take kernels
written by hand instead (``ops/cuda/sparse_rows.py`` over
``csrc/sparse_rows.cu``): the dedup sorts the ids once as int32 keys and sums
each run of equal ids in one block, in the order ``index_put_`` adds them (for
rows of one column, the order of its stride-1 kernel), so its ``uids`` and
``ugrads`` are the plain path's bit for bit; row-wise AdaGrad
updates each real slot's row and accumulator in place, each in one warp, and
skips the padding slots, so no row but the touched ones is written. Its mean
square sums in another order than ``torch.mean``, a few ulps. Both repeat
their bits run after run. ``lazy_adam`` takes the kernel's dedup and its
plain update.

The states are dataclasses of tensors, as in JAX; ``runtime/checkpoint.py``
saves them as plain dicts of their fields. Their ``init`` allocates on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import sparse_rows as _cuda
from deeplearningrecommendationsystem_tpu_torch.runtime.profiler import count, is_recording


def _on_kernels(ids: torch.Tensor, vocab: int, *rows: torch.Tensor) -> bool:
    """Whether the kernels take a call: ``rows`` on the card (the first one
    decides; the launcher checks the rest) and float32, int32 or int64 ids,
    all contiguous, and a sentinel ``vocab`` that an int32 key holds. Anything
    else takes the plain version."""
    return (rows[0].device.type == "cuda" and ids.dtype in _cuda.ID_DTYPES
            and ids.is_contiguous() and vocab <= _cuda.MAX_VOCAB
            and all(r.dtype in _cuda.ROW_DTYPES and r.is_contiguous() for r in rows))


def dedup_rows(
    ids: torch.Tensor, row_grads: torch.Tensor, vocab: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge duplicate ids in a batch of per-example row gradients: the
    kernel (``ops/cuda/sparse_rows.py``) where :func:`_on_kernels` says so,
    else :func:`dedup_rows_plain`; the same bits either way.

    Args:
      ids: ``[B]`` int ids into a ``[vocab, D]`` table (may repeat).
      row_grads: ``[B, D]`` gradient w.r.t. the gathered rows ``table[ids]``.
      vocab: table row count; used as the padding sentinel.

    Returns:
      ``(unique_ids [B], unique_grads [B, D])``: the distinct ids ascending,
      then ``vocab`` in every slot left over, with zero gradient rows there;
      ``unique_grads[j]`` is the sum of ``row_grads[i]`` over all ``i`` with
      ``ids[i] == unique_ids[j]`` (on the CPU added in row order, as XLA's
      scatter-add on the CPU adds them; on the card in the order of
      ``index_put_``: the rows of an id in their order in the batch, or for
      rows of one column in the order of its stride-1 kernel).
    """
    if _on_kernels(ids, vocab, row_grads):
        return _cuda.dedup_rows(ids, row_grads, vocab)
    return dedup_rows_plain(ids, row_grads, vocab)


def dedup_rows_plain(
    ids: torch.Tensor, row_grads: torch.Tensor, vocab: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`dedup_rows`."""
    B = ids.shape[0]
    sorted_ids, order = torch.sort(ids, stable=True)
    first = torch.ones(B, dtype=torch.bool, device=ids.device)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    slot_of_sorted = torch.cumsum(first, 0) - 1  # [B]: the unique slot of each sorted row
    slot = torch.empty_like(slot_of_sorted).scatter_(0, order, slot_of_sorted)
    uids = torch.full((B,), vocab, dtype=ids.dtype, device=ids.device)
    uids.scatter_(0, slot_of_sorted, sorted_ids)  # a slot's rows all write the same id
    ugrads = torch.zeros((B, row_grads.shape[-1]), dtype=row_grads.dtype, device=row_grads.device)
    if ugrads.is_cuda:
        ugrads.index_put_((slot,), row_grads, accumulate=True)
    else:
        ugrads.index_add_(0, slot, row_grads)
    return uids, ugrads


def _write_slots(uids: torch.Tensor, vocab: int):
    """(rows, dst, src, keep) for the ``[B]`` slots of ``uids``: ``rows`` the
    table row each slot reads (padding clamped to ``vocab - 1``); slot ``j``
    writes row ``dst[j]`` with the new values of slot ``src[j]``, a real slot
    its own, a padding slot the last real slot's (that slot's row and values),
    so no padding slot writes a row that is not touched. ``keep[j]`` is False
    only where no slot is real: every slot then writes row ``vocab - 1`` back
    with its old values."""
    B = uids.shape[0]
    real = uids < vocab
    last = (real.sum() - 1).clamp(min=0)  # the real slots come first (ascending ids)
    src = torch.where(real, torch.arange(B, device=uids.device), last)
    rows = uids.clamp(max=vocab - 1).long()
    return rows, rows[src], src, real[src]


def _scatter(buf: torch.Tensor, slots, new: torch.Tensor, old: torch.Tensor) -> None:
    """Write the slots' ``new`` values (``old``: the rows they read) into
    ``buf`` in place."""
    _, dst, src, keep = slots
    vals = torch.where(keep.view(-1, *[1] * (new.dim() - 1)), new[src], old[src])
    buf.index_copy_(0, dst, vals)


@dataclasses.dataclass
class RowwiseAdagradState:
    """One accumulator scalar per row (``[vocab]``)."""

    accum: torch.Tensor

    @classmethod
    def init(cls, vocab: int, init_accum: float = 0.0,
             device: str | torch.device = "cuda") -> "RowwiseAdagradState":
        return cls(accum=torch.full((vocab,), init_accum, dtype=torch.float32,
                                    device=resolve_device(device)))


def rowwise_adagrad(
    table: torch.Tensor,
    state: RowwiseAdagradState,
    uids: torch.Tensor,
    ugrads: torch.Tensor,
    lr: float,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, RowwiseAdagradState]:
    """Row-wise AdaGrad on the touched rows only; ``table`` and ``state`` are
    updated in place and returned.

    The accumulator is the running mean-square of each row's gradient over
    the embedding dim -- one scalar per row, so the state is ``vocab`` floats
    instead of Adam's ``2 * vocab * D``. The kernel
    (``ops/cuda/sparse_rows.py``) where :func:`_on_kernels` says so, else
    :func:`rowwise_adagrad_plain`.
    """
    if _on_kernels(uids, table.shape[0], table, state.accum, ugrads):
        _cuda.rowwise_adagrad(table, state.accum, uids, ugrads, lr, eps)
        return table, state
    return rowwise_adagrad_plain(table, state, uids, ugrads, lr, eps)


def rowwise_adagrad_plain(
    table: torch.Tensor,
    state: RowwiseAdagradState,
    uids: torch.Tensor,
    ugrads: torch.Tensor,
    lr: float,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, RowwiseAdagradState]:
    """Plain version of :func:`rowwise_adagrad`."""
    slots = _write_slots(uids, table.shape[0])
    rows = slots[0]
    g2 = torch.mean(torch.square(ugrads), dim=-1)  # [B]
    old_accum = state.accum.index_select(0, rows)
    accum_rows = old_accum + g2
    scale = lr / (torch.sqrt(accum_rows) + eps)  # [B]
    old_rows = table.index_select(0, rows)
    new_rows = old_rows - scale[:, None] * ugrads
    _scatter(state.accum, slots, accum_rows, old_accum)
    _scatter(table, slots, new_rows, old_rows)
    return table, state


@dataclasses.dataclass
class LazyAdamState:
    """Per-element moments in one ``[vocab, 2D]`` buffer (m = ``mv[:, :D]``,
    v = ``mv[:, D:]``, the JAX package's packing: one moment scatter a step)
    and the global step count (0-d int32)."""

    mv: torch.Tensor
    t: torch.Tensor

    @classmethod
    def init(cls, vocab: int, dim: int, device: str | torch.device = "cuda") -> "LazyAdamState":
        dev = resolve_device(device)
        return cls(mv=torch.zeros((vocab, 2 * dim), dtype=torch.float32, device=dev),
                   t=torch.zeros((), dtype=torch.int32, device=dev))

    @property
    def m(self) -> torch.Tensor:
        return self.mv[:, : self.mv.shape[1] // 2]

    @property
    def v(self) -> torch.Tensor:
        return self.mv[:, self.mv.shape[1] // 2 :]


def lazy_adam(
    table: torch.Tensor,
    state: LazyAdamState,
    uids: torch.Tensor,
    ugrads: torch.Tensor,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, LazyAdamState]:
    """Adam restricted to touched rows; ``table`` and ``state`` are updated in
    place and returned.

    Moments of untouched rows do not decay (the standard choice for
    embeddings: a row's moments advance only when the row is in the batch);
    the bias correction uses the global step count.
    """
    D = ugrads.shape[-1]
    slots = _write_slots(uids, table.shape[0])
    rows = slots[0]
    state.t += 1
    mv_rows = state.mv.index_select(0, rows)
    m_rows = b1 * mv_rows[:, :D] + (1.0 - b1) * ugrads
    v_rows = b2 * mv_rows[:, D:] + (1.0 - b2) * torch.square(ugrads)
    tf = state.t.float()
    m_hat = m_rows / (1.0 - torch.pow(b1, tf))
    v_hat = v_rows / (1.0 - torch.pow(b2, tf))
    old_rows = table.index_select(0, rows)
    new_rows = old_rows - lr * m_hat / (torch.sqrt(v_hat) + eps)
    _scatter(table, slots, new_rows, old_rows)
    _scatter(state.mv, slots, torch.cat([m_rows, v_rows], dim=-1), mv_rows)
    return table, state


def sparse_table_update(
    table: torch.Tensor,
    state,
    ids: torch.Tensor,
    row_grads: torch.Tensor,
    lr: float,
    **kw,
):
    """Dedup a batch's per-example row gradients, then apply the optimizer of
    ``state``'s type (in place). ``ids`` may repeat. ``dedup_rows`` and the
    optimizer are looked up in this module at each call, so a replacement set
    on the module (a test's, or a benchmark's planted fault) is what runs. While recording, the
    counter ``train.rows_touched`` adds the distinct rows updated (on the
    device: no step waits for it)."""
    uids, ugrads = dedup_rows(ids, row_grads, table.shape[0])
    if is_recording():
        count("train.rows_touched", (uids < table.shape[0]).sum())
    if isinstance(state, RowwiseAdagradState):
        return rowwise_adagrad(table, state, uids, ugrads, lr, **kw)
    if isinstance(state, LazyAdamState):
        return lazy_adam(table, state, uids, ugrads, lr, **kw)
    raise TypeError(f"unknown sparse optimizer state {type(state)!r}")
