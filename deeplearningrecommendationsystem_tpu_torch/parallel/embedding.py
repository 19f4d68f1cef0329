"""Row-sharded embedding tables over the 'model' mesh axis.

The JAX package's ``parallel/embedding.py`` on ``torch.distributed``. Each
model rank holds a contiguous row block ``[V_pad / m, D]`` of a table whose
vocabulary is zero-padded to a multiple of ``m`` (:func:`shard_table`); a
lookup is a collective:

* :func:`sharded_gather` (``psum``): every model rank holds the same ids; each
  gathers the rows it owns through the port's gather kernel on the ids
  clamped into its block, times the owned mask (other ranks' rows give
  zeros), and a sum over the model group assembles the [B, D] rows on every
  rank. The sum adds one nonzero row to zeros, so the rows are the dense
  gather's, bit for bit. The backward: the sum's is the identity, the mask's
  multiplies the cotangent by it, and the gather's is the ``onehot_grad``
  kernel into the rank's own block.
* :func:`sharded_gather_scatter` (``scatter``): each model rank holds its own
  block of the ids; they are all-gathered over the model group, each rank
  gathers the rows it owns as above, and a reduce-scatter hands each rank
  the rows of its own ids -- half the activation traffic of the sum. The
  backward all-gathers the cotangent, and ``onehot_grad`` sums it into the
  rank's block.

The ids are clamped into the block before the gather, as the JAX package
clamps them (``embedding.py:37-41``): the gather wraps a negative id once, so
raw ``ids - lo`` would read a row from the block's end. An id outside
``[0, vocab)`` is owned by no rank and gives a zero row, as in the JAX
package (the dense lookup clamps it instead).

A table argument here is always this rank's block, never the global table.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from deeplearningrecommendationsystem_tpu_torch.ops.embedding import GatherRows, dense_gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import embedding_init
from deeplearningrecommendationsystem_tpu_torch.parallel import collectives
from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_group,
    axis_size,
    coordinate,
)


def padded_height(vocab: int, m: int) -> int:
    """``vocab`` rounded up to a multiple of the model axis's size."""
    return ((vocab + m - 1) // m) * m


def shard_table(table: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's row block of ``table`` (the whole table, replicated on every
    rank), its vocabulary zero-padded to a multiple of the model axis (real
    vocabs -- ml-100k's 943/1682 -- are not divisible). Pad rows are never
    addressed by valid ids, receive zero gradient, and are dropped by
    ``parallel/ep.py::unshard_model_tables``."""
    m = axis_size(mesh, MODEL_AXIS)
    vocab = table.shape[0]
    rows = padded_height(vocab, m) // m
    lo = coordinate(mesh, MODEL_AXIS) * rows
    block = table[lo:min(lo + rows, vocab)]
    if block.shape[0] < rows:
        block = torch.cat([block, block.new_zeros((rows - block.shape[0],) + table.shape[1:])])
    return block.detach().clone()


def _owned_rows(table: torch.Tensor, ids: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """[N, D] rows of ``ids`` [N] this rank owns, zeros for the rest."""
    rows = table.shape[0]
    local = ids.long() - coordinate(mesh, MODEL_AXIS) * rows
    owned = (local >= 0) & (local < rows)
    out = GatherRows.apply(table, local.clamp(0, rows - 1).contiguous())
    return out * owned[:, None].to(out.dtype)


def sharded_gather(table: torch.Tensor, ids: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """[B] ids (the same on every model rank) -> [B, D] rows on every rank,
    ``table`` this rank's block."""
    return collectives.psum(_owned_rows(table, ids, mesh), axis_group(mesh, MODEL_AXIS))


def sharded_gather_scatter(table: torch.Tensor, ids: torch.Tensor,
                           mesh: DeviceMesh) -> torch.Tensor:
    """This rank's [b] ids -> their [b, D] rows, through an id all-gather and a
    reduce-scatter over the model group (every model rank holds as many ids)."""
    group = axis_group(mesh, MODEL_AXIS)
    all_ids = collectives.all_gather_tiled(ids.reshape(-1).contiguous(), group)
    return collectives.psum_scatter(_owned_rows(table, all_ids, mesh), group)


@dataclasses.dataclass
class ShardedEmbedding:
    """An embedding table row-sharded over the mesh's model axis.

    On a 1-sized model axis (or mesh=None) this is a plain dense gather.

    ``strategy``: 'psum' (masked gather + sum, every rank holds the batch's
    rows) or 'scatter' (id all-gather + reduce-scatter, each model rank holds
    the rows of its own ids).
    """

    vocab: int
    dim: int
    mesh: Optional[DeviceMesh] = None
    strategy: str = "psum"

    def _sharded(self) -> bool:
        return self.mesh is not None and axis_size(self.mesh, MODEL_AXIS) > 1

    def init(self, generator: torch.Generator) -> torch.Tensor:
        table = embedding_init(generator, self.vocab, self.dim)
        if self._sharded():
            table = shard_table(table, self.mesh)  # pads vocab to the axis
        return table

    def lookup(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if not self._sharded():
            return dense_gather_rows(table, ids)
        if self.strategy == "scatter":
            return sharded_gather_scatter(table, ids, self.mesh)
        return sharded_gather(table, ids, self.mesh)

