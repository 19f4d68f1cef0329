"""The device mesh and which rows of an array a rank holds.

The JAX package's ``parallel/mesh.py`` on ``torch.distributed``: a
``DeviceMesh`` over every rank of the default process group, with dims named
``("data", "model")``:

* ``data`` -- batch (DP): each data coordinate holds a slice of the batch;
  the gradients are summed over the data group after the backward
  (``train/trainer.py``), where JAX leaves that to GSPMD;
* ``model`` -- embedding rows (EP): each model coordinate holds a contiguous
  row block of every user/item table; lookups go through
  ``parallel/embedding.py``'s masked gather and a sum over the model group.

Rank ``r`` of a ``d x m`` mesh sits at ``(r // m, r % m)``, the JAX mesh's
row-major device order. A JAX ``NamedSharding`` says which part of a global
array each device holds; here an array is never global, so
:func:`data_sharding`, :func:`replicated` and :func:`model_row_sharding`
return a :class:`RowSharding`, the block of the leading axis this rank holds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank of the default process group.

    Defaults: every rank on the data axis, model axis of 1. ``device_type``
    defaults to ``"cuda"`` under NCCL and ``"cpu"`` under Gloo (the mesh moves
    no tensor itself: ``parallel/collectives.py`` does)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call runtime.distributed.initialize() first "
            "(or run under torchrun)")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{"data": d, "model": m}``: the JAX ``Mesh.shape``."""
    return {axis: axis_size(mesh, axis) for axis in AXES}


def coordinate(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that share this rank's other coordinate."""
    return mesh.get_group(axis)


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """The block of an array's leading axis this rank holds: the axis is cut
    into one block per combination of the ``axes`` coordinates, row-major in
    mesh order; ``axes=()`` is replicated (every rank holds all of it)."""

    mesh: DeviceMesh
    axes: Tuple[str, ...] = ()

    @property
    def parts(self) -> int:
        out = 1
        for axis in self.axes:
            out *= axis_size(self.mesh, axis)
        return out

    @property
    def index(self) -> int:
        out = 0
        for axis in self.axes:
            out = out * axis_size(self.mesh, axis) + coordinate(self.mesh, axis)
        return out

    def block(self, n: int) -> Tuple[int, int]:
        """[start, end) of this rank's block of n rows (n a multiple of ``parts``)."""
        if n % self.parts:
            raise ValueError(f"{n} rows do not split into {self.parts} blocks; pad first")
        per = n // self.parts
        return self.index * per, (self.index + 1) * per

    def take(self, x):
        """This rank's block of ``x`` (a tensor or NumPy array) along axis 0."""
        start, end = self.block(x.shape[0])
        return x[start:end]


def data_sharding(mesh: DeviceMesh, ndim: int = 1) -> RowSharding:
    """Shard the leading (batch) axis over 'data'; replicate the rest."""
    del ndim  # the JAX spec's rank; a block of rows has any
    return RowSharding(mesh, (DATA_AXIS,))


def replicated(mesh: DeviceMesh) -> RowSharding:
    return RowSharding(mesh, ())


def model_row_sharding(mesh: DeviceMesh, ndim: int = 2) -> RowSharding:
    """Shard the leading (vocab-row) axis over 'model' (embedding tables)."""
    del ndim
    return RowSharding(mesh, (MODEL_AXIS,))


def batch_sharding(mesh: DeviceMesh, strategy: str = "psum") -> RowSharding:
    """Where a full batch's rows go: over 'data' under the ``psum`` lookup,
    over every rank ('data' then 'model') under ``scatter``, whose lookups
    hand each model rank the rows of its own block of the batch."""
    if strategy == "scatter":
        return RowSharding(mesh, (DATA_AXIS, MODEL_AXIS))
    if strategy != "psum":
        raise ValueError(f"strategy {strategy!r}: 'psum' or 'scatter'")
    return RowSharding(mesh, (DATA_AXIS,))
