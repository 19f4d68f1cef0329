"""DIN's full-history catalog scorer: every item scored against each user's
complete, variable-length history, forward only.

The reference scores each user's whole unpadded history against every item
(model/din.py:55-66). The JAX package does so through XLA, in length buckets
of right-padded histories with a masked softmax
(``models/base.py::catalog_scores_full_history``), so this wrapper ports no
Pallas kernel. One public wrapper with its plain PyTorch version beside it:

* ``din_full_history_scores(item, att, fc, histories)``: the item table
  [I, D], DIN's attention MLP (3D -> A1 -> A2 -> 1) and fc MLP (2D -> F1 ->
  F2 -> 1) as layer lists, and one 1-D id array per user -> logits [U, I].
  Its plain version, ``din_full_history_scores_plain``, is the bucketed
  scorer ``catalog_scores_full_history`` over ``masked_logits``, the route
  DIN's full-history serving took before the kernel and still takes at the
  shapes ``full_history_route`` refuses.

Dispatch is by device only: CPU tensors take the plain version, CUDA tensors
launch the kernels (``ops/cuda/din_full_history.py``: the ragged attention
kernel, then the float32 DIN head's fc head) or raise. On the card the
histories are packed once a call as CSR (``pack_histories``) and copied in one
non-blocking copy from pinned memory; the kernel walks each user's true
length, two positions at a time, and the catalog in tiles of 16 items, over
chunks of users whose pooled rows fit a fixed budget
(``ops/cuda/din_full_history.py::users_per_launch``).

Spans and counters, while the recorder is on (``runtime/profiler.py``):
``serve.buckets`` around packing the histories and their copy, ``serve.tile``
around the launches; ``serve.positions_real``, each user's history length
times the items, and ``serve.positions_scored``, what the kernel computes
(``positions_scored``). The plain version records the bucketed scorer's own.

The kernel drops the attention net's last bias, which cancels in the
softmax; the plain version keeps it, so the two agree to rounding, not bit
for bit.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from deeplearningrecommendationsystem_tpu_torch.device import on_cpu as _on_cpu
from deeplearningrecommendationsystem_tpu_torch.ops.attention import attention_pool
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_full_history as _cuda
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp
from deeplearningrecommendationsystem_tpu_torch.runtime import profiler

Layers = Sequence[Mapping[str, torch.Tensor]]


def full_history_route(item: torch.Tensor, att: Layers, fc: Layers) -> bool:
    """Whether the full-history kernel takes the item table ``item`` [I, D]
    and the nets ``att``, ``fc``: the launcher's own check of them
    (``ops/cuda/din_full_history.py::widths``): every tensor float32; an
    attention net of exactly 3D -> A1 -> A2 -> 1 with biases on its hidden
    layers, D, A1 and A2 multiples of 4, D at most 64 and the split second
    layer within shared memory; an fc net 2D -> F1 -> F2 -> 1 that the float32
    head's fc kernel takes (``TF32_FWD``). Decided from dtypes and shapes
    alone, before any launch; any other DIN (bf16 weights, other depths or
    widths) takes ``catalog_scores_full_history``."""
    try:
        _cuda.widths(item, att, fc)
    except (TypeError, ValueError):
        return False
    return True


def history_lengths(histories: Sequence[np.ndarray]) -> np.ndarray:
    """Each user's length [U] int64, an empty history counted as one position."""
    return np.maximum(np.array([len(h) for h in histories], np.int64), 1)


def pack_histories(histories: Sequence[np.ndarray], lengths: np.ndarray, users: int,
                   out: np.ndarray) -> None:
    """Writes one int32 buffer ``out`` [2 U + 1 + N], N = ``lengths.sum()``:
    offsets (U + 1), order (U), ids (N). An empty history is one position of
    item 0, as the bucketed scorer pads it; ``order`` takes the users in
    chunks of ``users``, one chunk a launch, and lists each chunk's users
    longest history first (a stable sort), numbered from the chunk's first:
    the order the kernel takes its units in."""
    U = len(histories)
    out[0] = 0
    np.cumsum(lengths, out=out[1:U + 1], dtype=np.int32)
    for u0 in range(0, U, users):
        out[U + 1 + u0:U + 1 + min(U, u0 + users)] = np.argsort(-lengths[u0:u0 + users],
                                                                kind="stable")
    parts = [h if len(h) else np.zeros(1, np.int32) for h in histories]
    np.concatenate(parts, out=out[2 * U + 1:], casting="unsafe")


def positions_scored(lengths: np.ndarray, num_items: int) -> int:
    """The (user, item, position) triples the kernel computes: each user's
    length rounded up to its step of POSITION_STEP positions, times the items
    rounded up to its tile of ITEM_TILE."""
    step, tile = _cuda.POSITION_STEP, _cuda.ITEM_TILE
    return int((-(-lengths // step) * step).sum()) * (-(-num_items // tile) * tile)


def products_needed(lengths: np.ndarray, num_items: int, D: int, A: Sequence[int],
                    F: Sequence[int]) -> int:
    """The products (two operations a multiply-add) that scoring every item
    against the histories of ``lengths`` needs with the first attention
    layer made once per item, as the kernel makes it: HW and TW (2 I D A1
    each), per (position, item) the second layer and its score (2 A1 A2 +
    2 A2), per (user, item) the fc head (2 (2D) F1 + 2 F1 F2 + 2 F2). The
    padding of ``positions_scored`` is not counted: it is not needed."""
    A1, A2 = A[0], A[1]
    F1, F2 = F[0], F[1]
    positions, users = int(lengths.sum()), len(lengths)
    return (positions * num_items * (2 * A1 * A2 + 2 * A2)
            + users * num_items * (2 * (2 * D) * F1 + 2 * F1 * F2 + 2 * F2)
            + 2 * (2 * num_items * D * A1))


def masked_logits(item: torch.Tensor, att: Layers, fc: Layers, hist_e: torch.Tensor,
                  target: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Logits [B] of right-padded embedded histories with their valid lengths,
    hist_e [B, L, D], target [B] (item ids) and length [B]: the masked
    softmax over the first ``length`` positions is the reference's softmax over
    the unpadded history (model/din.py:39-47), then the fc head."""
    target_e = gather_rows(item, target)
    mask = torch.arange(hist_e.shape[1], device=hist_e.device)[None, :] < length[:, None]
    pooled = attention_pool(att, hist_e, target_e, mask)
    return mlp(fc, torch.cat([pooled, target_e], dim=-1))[:, 0]


def din_full_history_scores_plain(item: torch.Tensor, att: Layers, fc: Layers,
                                  histories: Sequence[np.ndarray]) -> torch.Tensor:
    """Plain version of :func:`din_full_history_scores`: the bucketed, masked
    scorer, each user tile's history embedded once."""
    # imported here: models/ imports this module through models/din.py
    from deeplearningrecommendationsystem_tpu_torch.models.base import catalog_scores_full_history

    def apply_embedded(_, batch):
        return masked_logits(item, att, fc, *batch)

    # the embed-once route, which never calls apply_len_fn
    return catalog_scores_full_history(None, None, histories, item.shape[0], item.device,
                                       embed_fn=lambda _, hist: gather_rows(item, hist),
                                       apply_embedded_fn=apply_embedded)


def din_full_history_scores(item: torch.Tensor, att: Layers, fc: Layers,
                            histories: Sequence[np.ndarray]) -> torch.Tensor:
    """Logits [U, I] of every item against each user's complete history."""
    if _on_cpu(item, *(t for layer in (*att, *fc) for t in layer.values())):
        return din_full_history_scores_plain(item, att, fc, histories)
    dev = item.device
    num_items, n = item.shape[0], len(histories)
    users = _cuda.users_per_launch(n, num_items, item.shape[1])
    with profiler.span("serve.buckets"):
        lengths = history_lengths(histories)
        pinned = torch.empty(2 * n + 1 + int(lengths.sum()), dtype=torch.int32, pin_memory=True)
        pack_histories(histories, lengths, users, pinned.numpy())
        ids = pinned.numpy()[2 * n + 1:]
        if ids.min() < 0 or ids.max() >= num_items:
            raise ValueError(f"history ids lie outside the {num_items} items")
        packed = pinned.to(dev, non_blocking=True)
    if profiler.is_recording():
        profiler.count("serve.positions_real", int(lengths.sum()) * num_items)
        profiler.count("serve.positions_scored", positions_scored(lengths, num_items))
    with profiler.span("serve.tile"):
        return _cuda.din_full_history_scores(packed[:n + 1], packed[n + 1:2 * n + 1],
                                             packed[2 * n + 1:], item, att, fc, users)
