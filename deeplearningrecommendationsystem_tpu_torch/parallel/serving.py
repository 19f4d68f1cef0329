"""Sharded serving: full-catalog top-k with the item table row-sharded (EP).

The JAX package's ``parallel/serving.py`` on ``torch.distributed``. A
replicated item table is exactly what does not fit on one device at
production vocabularies, so serving runs on the row-sharded layout training
left (``unshard_params=False``), with no unshard round trip:

* each model rank holds a contiguous item-row block ``[I_pad / m, D]`` of the
  (vocab-padded) item table and takes the matching column block of ``seen``,
  in which it also marks the vocab-pad columns;
* it scores its block and takes a local top-k: the port's
  ``topk_serve_matmul`` kernel for a factored model (:func:`sharded_topk`),
  the model's own forward in user tiles and the ``topk_scores`` kernel for a
  feature model (:func:`sharded_feature_topk`);
* the local winners shift to global ids, and the ``[U, m * k]`` candidates
  are all-gathered over the model group, block-major;
* the ``topk_scores`` kernel takes the final k of the candidates. The global
  top-k lies in the union of the blocks' top-k, and the candidates' order
  (block-major, rank-minor) keeps the lowest-id-first tie rule, since block
  order is id order.

Every rank returns the same lists. Item rows never leave their block; a
query moves the candidates and the request's user rows.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from deeplearningrecommendationsystem_tpu_torch.ops.serving_topk import topk_scores, topk_serve_matmul
from deeplearningrecommendationsystem_tpu_torch.parallel import collectives
from deeplearningrecommendationsystem_tpu_torch.parallel.embedding import sharded_gather
from deeplearningrecommendationsystem_tpu_torch.parallel.ep import (
    embedding_partitioning,
    gather_rows,
    set_parameters,
)
from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_group,
    axis_size,
    coordinate,
)


def _seen_block(seen: Optional[torch.Tensor], users: int, lo: int, rows: int, num_items: int,
                device) -> torch.Tensor:
    """[users, rows] int8 of the block [lo, lo + rows): 1 where ``seen`` (the
    request's rows, [users, >= num_items]) is set or the column is vocab padding."""
    out = torch.ones((users, rows), dtype=torch.int8, device=device)
    real = max(0, min(num_items, lo + rows) - lo)
    if seen is None:
        out[:, :real] = 0
    else:
        out[:, :real] = seen[:, lo:lo + real].to(device=device, dtype=torch.int8)
    return out.contiguous()


def _merge(vals: torch.Tensor, gids: torch.Tensor, mesh: DeviceMesh, k: int):
    """The final k of every model rank's [U, k] candidates (block-major)."""
    group = axis_group(mesh, MODEL_AXIS)
    m = axis_size(mesh, MODEL_AXIS)
    U = vals.shape[0]

    def gather(x):  # [U, k] on each rank -> [U, m * k], rank-major along the candidates
        return collectives.all_gather_tiled(x.contiguous(), group).view(m, U, k).transpose(
            0, 1).reshape(U, m * k)

    cand_v, cand_i = gather(vals), gather(gids)
    no_seen = torch.zeros(cand_v.shape, dtype=torch.int8, device=cand_v.device)
    fv, pos = topk_scores(cand_v.contiguous(), no_seen, k)
    return fv, torch.gather(cand_i, 1, pos.long())


def _check_k(k: int, rows: int) -> None:
    if k > rows:
        raise ValueError(
            f"k={k} exceeds items per shard ({rows}); the union-of-local-top-k argument "
            "needs k <= I_pad/m")


@torch.no_grad()
def sharded_topk(
    Pu: torch.Tensor,
    Q: torch.Tensor,
    mesh: DeviceMesh,
    num_items: int,
    k: int,
    seen: Optional[torch.Tensor] = None,
):
    """Exact top-k of ``Pu @ Q_full[:num_items].T`` with ``Q`` this rank's row
    block of the item factors.

    ``Pu``: [U, D] user factors (the same on every model rank). ``seen``:
    optional [U, >= num_items] (nonzero = exclude; columns past ``num_items``
    ignored). Returns (values [U, k] float32, item ids [U, k] int32), the same
    on every rank and equal to the dense mask + stable top-k, ties included.
    """
    rows = Q.shape[0]
    _check_k(k, rows)
    lo = coordinate(mesh, MODEL_AXIS) * rows
    blk = _seen_block(seen, Pu.shape[0], lo, rows, num_items, Q.device)
    vals, local = topk_serve_matmul(Pu.float().contiguous(), Q.float().contiguous(), blk, k)
    return _merge(vals, local + lo, mesh, k)


@contextlib.contextmanager
def holding(model: nn.Module, params: Mapping[str, torch.Tensor]):
    """Scope under which ``model``'s parameters named in ``params`` are those
    tensors (a row block may replace a whole table); restored on exit."""
    saved = {name: model.get_parameter(name) for name in params}
    set_parameters(model, params)
    try:
        yield model
    finally:
        set_parameters(model, saved)


@torch.no_grad()
def sharded_feature_topk(
    model,
    params: Mapping[str, torch.Tensor],
    ctx,
    mesh: DeviceMesh,
    k: int,
    seen: Optional[torch.Tensor] = None,
    users: Optional[torch.Tensor] = None,
    user_tile: int = 64,
):
    """Exact top-k for a joint-MLP FEATURE model with item tables row-sharded.

    A DeepFM-style model scores each (user, item) pair through a joint MLP,
    so each model rank runs the model's own ``apply_params`` on its item
    block (the table substitution of the JAX package):

    * the model's ``sparse_tables`` name every user-vocab and item-vocab table;
    * each user-vocab table is replaced by the request's rows (gathered with
      ``sharded_gather`` where the table is sharded) and the feature matrix's
      user-id column counts the request's users: ids feed only table lookups,
      so every activation is unchanged;
    * each item-vocab table is this rank's block, and the item-id column
      counts 0 .. rows - 1 of the block;
    * the block's scores, ``user_tile`` users at a time, take the
      ``topk_scores`` kernel with the block's seen and pad columns masked, and
      the winners merge as in :func:`sharded_topk`.
    """
    m = axis_size(mesh, MODEL_AXIS)
    table_paths = dict(model.sparse_tables)
    user_paths = {n: p for n, p in table_paths.items() if "user" in n}
    item_paths = {n: p for n, p in table_paths.items() if "item" in n}
    if not (user_paths and item_paths):
        raise ValueError("sharded_feature_topk needs sparse_tables naming user_* and item_* "
                         f"vocab tables; got {sorted(table_paths)}")
    num_items, num_users = ctx.num_items, ctx.num_users
    rows = params[next(iter(item_paths.values()))].shape[0]
    for p in item_paths.values():
        if params[p].shape[0] != rows:
            raise ValueError("item table heights differ")
    if rows * m < num_items:
        raise ValueError(f"item tables of {rows} rows are not blocks of {num_items} items over "
                         f"{m} ranks; shard with shard_model_tables first")
    _check_k(k, rows)
    dev = ctx.item_features.device
    ids = (torch.as_tensor(users, device=dev).long() if users is not None
           else torch.arange(num_users, device=dev))
    U_req = ids.shape[0]

    sub: Dict[str, torch.Tensor] = dict(params)
    for path in user_paths.values():
        tab = params[path]
        sub[path] = (gather_rows(tab, ids) if tab.shape[0] == num_users
                     else sharded_gather(tab, ids, mesh))
    lo = coordinate(mesh, MODEL_AXIS) * rows
    real = max(0, min(num_items, lo + rows) - lo)
    item_feat = ctx.item_features.float()[lo:lo + real]
    if real < rows:
        item_feat = torch.cat([item_feat, item_feat.new_zeros((rows - real, item_feat.shape[1]))])
    i_blk = torch.cat([torch.arange(rows, dtype=torch.float32, device=dev)[:, None], item_feat], 1)
    uf = ctx.user_features.float()[ids]
    scores = torch.empty((U_req, rows), dtype=torch.float32, device=dev)
    # the block's lookups are dense: no EP scope may route them
    for u0 in range(0, U_req, user_tile):
        T = min(user_tile, U_req - u0)
        u_col = torch.arange(u0, u0 + T, device=dev).float()[:, None, None].expand(T, rows, 1)
        u_feat = uf[u0:u0 + T][:, None, :].expand(T, rows, uf.shape[1])
        blk = i_blk[None].expand(T, rows, i_blk.shape[1])
        x = torch.cat([u_col, blk[..., :1], u_feat, blk[..., 1:]], dim=-1)
        with embedding_partitioning(None):
            scores[u0:u0 + T] = model.apply_params(sub, x.reshape(T * rows, -1)).reshape(T, rows)
    req_seen = None if seen is None else torch.as_tensor(seen, device=dev)[ids]
    mask = _seen_block(req_seen, U_req, lo, rows, num_items, dev)
    vals, local = topk_scores(scores, mask, k)
    return _merge(vals, local + lo, mesh, k)


@torch.no_grad()
def sharded_catalog_topk(
    model,
    params: Mapping[str, torch.Tensor],
    ctx,
    mesh: DeviceMesh,
    k: int,
    seen: Optional[torch.Tensor] = None,
    users: Optional[torch.Tensor] = None,
):
    """Top-k recommendations from EP-SHARDED params, no unshard round trip.

    ``params`` as training with ``unshard_params=False`` left them (name ->
    tensor, the sharded tables this rank's blocks). Routing:

    * models exposing ``serving_factors`` (scores == P @ Q^T: MF) --
      :func:`sharded_topk`, one fused matmul + top-k a rank;
    * joint-MLP FEATURE models exposing ``sparse_tables`` and a ``spec``
      (DeepFM shapes) -- :func:`sharded_feature_topk`;
    * anything else (sequence models whose history lookups span the whole item
      table, DIN/DIEN) raises: serve those by unsharding
      (``parallel/ep.py::unshard_model_tables``).
    """
    if not hasattr(model, "serving_factors"):
        if hasattr(model, "sparse_tables") and hasattr(model, "spec"):
            return sharded_feature_topk(model, params, ctx, mesh, k, seen=seen, users=users)
        raise NotImplementedError(
            f"{type(model).__name__}: sharded serving needs serving_factors "
            "(factored scores) or the sparse_tables+spec feature protocol; "
            "sequence models (DIN/DIEN) must unshard for serving "
            "(parallel/ep.py::unshard_model_tables)")
    with holding(model, params):
        Pf, Qf = model.serving_factors(ctx)
    dev = Qf.device
    ids = (torch.as_tensor(users, device=dev).long() if users is not None
           else torch.arange(ctx.num_users, device=dev))
    if Pf.shape[0] != ctx.num_users:
        # the user table is sharded too: gather the request's rows
        P_req = sharded_gather(Pf.detach(), ids, mesh)
    else:
        P_req = gather_rows(Pf.detach(), ids)
    req_seen = None if seen is None else torch.as_tensor(seen, device=dev)[ids]
    return sharded_topk(P_req, Qf.detach(), mesh, ctx.num_items, k, seen=req_seen)
