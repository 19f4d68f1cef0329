"""Data-parallel batch placement.

The JAX package's ``parallel/data.py``. Full-batch sizes on ml-100k are
arbitrary (positives + negatives per split), so the batch is padded up to a
multiple of the number of blocks it is cut into and the pad rows get weight
0 -- the Trainer's weighted BCE then ignores them, keeping the loss and the
metrics those of the unpadded batch. Each rank then keeps its own block:
over the data axis under the ``psum`` lookup, over every rank (data, then
model) under ``scatter`` (``parallel/mesh.py::batch_sharding``).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from deeplearningrecommendationsystem_tpu_torch.data.stream import tree_map
from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import batch_sharding


def _pad_rows(x: torch.Tensor, target: int) -> torch.Tensor:
    pad = target - x.shape[0]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def pad_and_shard(
    batch: Any,
    labels: torch.Tensor,
    mesh: DeviceMesh,
    weights: Optional[torch.Tensor] = None,
    strategy: str = "psum",
) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """Pad every leading axis to a multiple of the block count, attach zero
    weights to pad rows, and keep this rank's block (on the device the
    tensors are on).

    Returns (batch, labels, weights), this rank's rows of each.
    """
    sharding = batch_sharding(mesh, strategy)
    n = labels.shape[0]
    parts = sharding.parts
    target = ((n + parts - 1) // parts) * parts
    if weights is None:
        weights = torch.ones((n,), dtype=torch.float32, device=labels.device)
    pad = lambda x: sharding.take(_pad_rows(x, target)).contiguous()  # noqa: E731
    return tree_map(pad, batch), pad(labels), pad(weights)
