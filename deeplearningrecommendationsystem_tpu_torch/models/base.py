"""Model protocol and the serving context.

A model here is an ``nn.Module`` holding its parameters, with

* ``forward(batch) -> logits`` (pre-sigmoid scores), and
* ``score_catalog(ctx) -> [U, I] logits`` -- the serving path,

and, for factored models, ``serving_factors(ctx) -> (P, Q)`` with
``scores == P @ Q^T``, which lets serving fuse scoring, the seen mask and the
top-k into one kernel without materialising [U, I].

``catalog_scores_from_features`` scores the full catalog for a
feature-vector model, one tile of users at a time,
``catalog_scores_from_pairs`` for an id-pair model;
``catalog_scores_from_history`` does so for a behaviour-sequence model from
each user's fixed-length history window, and ``catalog_scores_full_history``
from each user's complete variable-length history.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.runtime import profiler


def init_generator(generator: Optional[torch.Generator],
                   device: str | torch.device) -> torch.Generator:
    """The generator a model draws its initial weights from: ``generator``, or
    one seeded with 0 on ``device``; it must lie on the model's device type."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator is on {generator.device}, the model on {dev}")
    return generator


@dataclasses.dataclass
class ServingContext:
    """Device-resident feature blocks needed to score the full catalog."""

    user_features: torch.Tensor  # [U, 24] = [age, gender(2), occupation(21)]
    item_features: torch.Tensor  # [I, 19] genre flags
    history: Optional[torch.Tensor] = None  # [U, L] behaviour histories (DIN, DIEN)
    rating_matrix: Optional[torch.Tensor] = None  # [U, I], or [I, U] item-major (AutoRec)
    # per-user COMPLETE variable-length histories (host-side ragged id arrays);
    # when set, DIN and DIEN serve with the reference's full-history semantics
    # (model/din.py:55-66) through catalog_scores_full_history
    full_histories: Optional[Sequence[np.ndarray]] = None

    @property
    def num_users(self) -> int:
        return self.user_features.shape[0]

    @property
    def num_items(self) -> int:
        return self.item_features.shape[0]

    def to(self, device: torch.device) -> "ServingContext":
        return dataclasses.replace(
            self,
            user_features=torch.as_tensor(self.user_features, device=device),
            item_features=torch.as_tensor(self.item_features, device=device),
            history=None if self.history is None else torch.as_tensor(self.history, device=device),
            rating_matrix=(None if self.rating_matrix is None
                           else torch.as_tensor(self.rating_matrix, device=device)),
        )


def catalog_scores_from_features(apply_fn: Callable, params: Any, ctx: ServingContext,
                                 tile: int = 64) -> torch.Tensor:
    """[U, I] logits of a feature-vector model, ``apply_fn(params, x [B, 45])
    -> [B]``.

    The JAX package's ``lax.map`` over user tiles is a Python loop here: each
    tile of ``tile`` users builds its [tile * I, 45] feature block on the
    device (user id, item id, user block, item block broadcast together) and
    scores it in one call, so the all-pairs matrix never exists at once. The
    last tile is shorter instead of padded. Span: ``serve.tile``, a tile.
    """
    U, I = ctx.num_users, ctx.num_items
    dev = ctx.user_features.device
    uf = ctx.user_features.float()
    item_block = torch.cat(
        [torch.arange(I, dtype=torch.float32, device=dev)[:, None], ctx.item_features.float()], 1
    )  # [I, 20]
    scores = torch.empty((U, I), dtype=torch.float32, device=dev)
    for u0 in range(0, U, tile):
        with profiler.span("serve.tile"):
            ids = torch.arange(u0, min(U, u0 + tile), device=dev)
            T = ids.shape[0]
            u_col = ids.float()[:, None, None].expand(T, I, 1)
            u_feat = uf[ids][:, None, :].expand(T, I, uf.shape[1])
            i_blk = item_block[None].expand(T, I, item_block.shape[1])
            x = torch.cat([u_col, i_blk[..., :1], u_feat, i_blk[..., 1:]], dim=-1)
            scores[u0:u0 + T] = apply_fn(params, x.reshape(T * I, -1)).reshape(T, I)
    return scores


def catalog_scores_from_pairs(apply_fn: Callable, params: Any, num_users: int, num_items: int,
                              device: str | torch.device, tile: int = 64) -> torch.Tensor:
    """[U, I] logits on ``device`` of an id-pair model, ``apply_fn(params,
    (users [B], items [B])) -> [B]`` (NeuralCF).

    The JAX package's ``lax.map`` over tiles of ``tile`` users is a Python loop
    here: each tile is one (tile * I)-row batch of every (user, item) pair. As
    in the JAX scorer, the user ids are padded to whole tiles by ``% U`` (the
    pad rows score users 0, 1, ... again and are dropped), so every tile is one
    shape.
    """
    dev = torch.device(device)
    U_pad = -(-num_users // tile) * tile
    user_ids = torch.arange(U_pad, device=dev) % num_users
    items = torch.arange(num_items, device=dev)
    scores = torch.empty((U_pad, num_items), dtype=torch.float32, device=dev)
    for u0 in range(0, U_pad, tile):
        ids = user_ids[u0:u0 + tile]
        batch = (ids.repeat_interleave(num_items), items.repeat(tile))
        scores[u0:u0 + tile] = apply_fn(params, batch).reshape(tile, num_items)
    return scores[:num_users]


def catalog_scores_from_history(apply_fn: Callable, params: Any, history: torch.Tensor,
                                num_items: int, tile: int = 16) -> torch.Tensor:
    """[U, I] logits of a behaviour-sequence model, ``apply_fn(params, (hist
    [B, L], target [B])) -> [B]``, from each user's history window [U, L].

    Each user's history is broadcast across the catalog, as the reference
    repeats it num_items times per user (model/din.py:55-66): a tile of
    ``tile`` users is one [tile * I, L] batch. The last tile is shorter instead
    of padded.
    """
    U, L = history.shape
    dev = history.device
    targets = torch.arange(num_items, device=dev)
    scores = torch.empty((U, num_items), dtype=torch.float32, device=dev)
    for u0 in range(0, U, tile):
        hist_t = history[u0:u0 + tile]
        T = hist_t.shape[0]
        h = hist_t[:, None, :].expand(T, num_items, L).reshape(-1, L)
        scores[u0:u0 + T] = apply_fn(params, (h, targets.repeat(T))).reshape(T, num_items)
    return scores


def catalog_scores_full_history(
    apply_len_fn: Callable,
    params: Any,
    histories: Sequence[np.ndarray],
    num_items: int,
    device: str | torch.device,
    buckets: tuple = (32, 64, 128, 256, 512, 1024),
    elem_budget: int = 32 * 1024 * 1024,
    embed_fn: Optional[Callable] = None,
    apply_embedded_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """[U, I] logits on ``device`` scoring each user's COMPLETE variable-length
    history (the JAX package's ``models/base.py::catalog_scores_full_history``).

    The reference forwards, per user, the whole unpadded history against every
    item (model/din.py:55-66). Here users are grouped into length buckets,
    right-padded to the bucket length with an explicit valid length, and each
    bucket is scored in tiles of users by chunks of at most 256 items; masked
    attention over the true positions equals the reference's exact-length
    softmax. ``apply_len_fn(params, (hist [B, Lb], target [B], length [B])) ->
    [B]``; ``histories``: one 1-D id array per user; ``elem_budget`` caps the
    [B, Lb, D]-shaped tile (D taken as 64). The last tile of a bucket is
    shorter instead of padded.

    Embed-once path: given ``embed_fn(params, hist [T, Lb]) -> [T, Lb, D]``
    and ``apply_embedded_fn(params, (hist_e [B, Lb, D], target [B], length
    [B])) -> [B]``, each user tile's history is embedded once and broadcast
    across the item chunks; the scores are the same.

    Spans: ``serve.buckets`` around building each bucket's padded histories
    and lengths and copying them to the device, ``serve.tile`` around each
    user tile. While recording, the counters ``serve.positions_real`` (each
    user's history length times the items) and ``serve.positions_scored``
    (each bucket's users times its length times the items padded to whole
    chunks): their ratio is the share of the scored (user, item, position)
    work that is not padding.
    """
    dev = torch.device(device)
    U = len(histories)
    lengths = np.array([max(len(h), 1) for h in histories], dtype=np.int64)
    maxlen = int(lengths.max())
    bucket_list = [b for b in buckets if b < maxlen]
    top = next((b for b in buckets if b >= maxlen), None)
    bucket_list.append(top if top is not None else maxlen)
    embed_once = embed_fn is not None and apply_embedded_fn is not None

    scores = torch.zeros((U, num_items), dtype=torch.float32, device=dev)
    chunk = min(num_items, 256)
    i_pad = -(-num_items // chunk) * chunk
    targets = torch.zeros(i_pad, dtype=torch.int64, device=dev)
    targets[:num_items] = torch.arange(num_items, device=dev)
    targets = targets.reshape(-1, chunk)
    if profiler.is_recording():
        profiler.count("serve.positions_real", int(lengths.sum()) * num_items)
    lo = 0
    for Lb in bucket_list:
        sel = np.where((lengths > lo) & (lengths <= Lb))[0]
        lo = Lb
        if sel.size == 0:
            continue
        tile = max(1, min(64, elem_budget // (chunk * Lb * 64)))
        with profiler.span("serve.buckets"):
            hist_b = np.zeros((sel.size, Lb), dtype=np.int64)  # right-pad with 0
            len_b = np.ones((sel.size,), dtype=np.int64)
            for j, u in enumerate(sel):
                h = np.asarray(histories[u], dtype=np.int64)
                hist_b[j, :len(h)] = h
                len_b[j] = max(len(h), 1)
            hist_d, len_d = torch.from_numpy(hist_b).to(dev), torch.from_numpy(len_b).to(dev)
            sel_d = torch.from_numpy(sel).to(dev)
        profiler.count("serve.positions_scored", sel.size * Lb * i_pad)
        for u0 in range(0, sel.size, tile):
            with profiler.span("serve.tile"):
                hist_t, len_t = hist_d[u0:u0 + tile], len_d[u0:u0 + tile]
                T = hist_t.shape[0]
                he_t = embed_fn(params, hist_t) if embed_once else None  # [T, Lb, D]
                lens = len_t.repeat_interleave(chunk)
                out = []
                for tgt in targets:
                    t = tgt.repeat(T)
                    if embed_once:
                        D = he_t.shape[-1]
                        he = he_t[:, None].expand(T, chunk, Lb, D).reshape(-1, Lb, D)
                        out.append(apply_embedded_fn(params, (he, t, lens)).reshape(T, chunk))
                    else:
                        h = hist_t[:, None, :].expand(T, chunk, Lb).reshape(-1, Lb)
                        out.append(apply_len_fn(params, (h, t, lens)).reshape(T, chunk))
                scores[sel_d[u0:u0 + T]] = torch.cat(out, dim=1)[:, :num_items].float()
    return scores
