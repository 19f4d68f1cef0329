"""EP dispatch: route every id-table lookup through the sharded strategies.

The JAX package's ``parallel/ep.py`` on ``torch.distributed``. One scope,
:func:`embedding_partitioning`, turns every id-table lookup of every model
into a row-sharded collective gather (``parallel/embedding.py``) with no
change to the models: they call ``ops/embedding.py::gather_rows`` (the
:func:`gather_rows` here) instead of ``table[ids]``, the scope registers
:func:`sharded_lookup` as that function's route, and the active
:class:`EmbeddingPartitioning` (:func:`active_partitioning`) decides, at each
call, whether that is the dense gather (one rank, or a small replicated side
table such as gender/occupation) or a collective over the mesh's model axis.

Tables are picked by parameter name: :data:`EP_TABLE_KEYS` lists the last
component of every user/item-vocab table's name across the zoo (user, item,
gmf_user, ..., user_id.user, ...). :func:`shard_model_tables` replaces exactly
those by this rank's row block (the vocabulary padded to the axis size) and
records the padded heights, by which :func:`gather_rows` recognises a block:
a 2-D table whose height times the model axis's size is a sharded height (the
JAX package compares the global height; a rank holds only its block).

Under the ``scatter`` strategy every lookup of a routed table takes the
scatter variant: each model rank holds its own block of the batch, so the
``psum`` variant, which needs the same ids on every model rank, is never a
fallback (the JAX package falls back to it where the batch does not divide
the axis; here the batch is padded so that it does).

The JAX package's TPU gather-route scopes (``onehot_gather_fwd``,
``pallas_gather_mm``, ``matmul_gather_backward``) chose among lowerings of
the dense lookup; the port has one kernel pair, and the Trainer accepts their
flags with no effect.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, FrozenSet, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from deeplearningrecommendationsystem_tpu_torch.ops.embedding import (  # noqa: F401
    dense_gather_rows,
    gather_rows,  # the lookup the models call, re-exported as the JAX package's
    set_lookup_route,
)
from deeplearningrecommendationsystem_tpu_torch.parallel import collectives
from deeplearningrecommendationsystem_tpu_torch.parallel.embedding import (
    shard_table,
    sharded_gather,
    sharded_gather_scatter,
)
from deeplearningrecommendationsystem_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    axis_group,
    axis_size,
)

# Last name components that hold a user/item-vocab embedding table anywhere
# in the zoo's parameters. Everything else (MLP weights, small field tables
# like gender[2]/occupation[21]/genre[19]) stays replicated.
EP_TABLE_KEYS: FrozenSet[str] = frozenset(
    {
        "user", "item",                                    # mf, din/dien ('item'), field tables
        "gmf_user", "gmf_item", "mlp_user", "mlp_item",    # neuralcf
        "user_bias", "item_bias",                          # every wide/linear part
        "user_id.user", "user_id.item", "item_id.user", "item_id.item",  # ffm
    }
)
STRATEGIES = ("psum", "scatter")


@dataclasses.dataclass(frozen=True)
class EmbeddingPartitioning:
    """Active EP policy: which mesh, which strategy, which table heights."""

    mesh: DeviceMesh
    strategy: str = "psum"  # 'psum' | 'scatter'
    # padded (global) heights of the tables that were row-sharded;
    # gather_rows treats any other table as replicated.
    sharded_heights: FrozenSet[int] = frozenset()

    def routes(self, table: torch.Tensor) -> bool:
        m = axis_size(self.mesh, MODEL_AXIS)
        return m > 1 and table.dim() == 2 and table.shape[0] * m in self.sharded_heights


_ACTIVE: Optional[EmbeddingPartitioning] = None


@contextlib.contextmanager
def embedding_partitioning(cfg: Optional[EmbeddingPartitioning]):
    """Scope under which gather_rows routes matching tables through EP. The
    lookups run eagerly, so the scope wraps every forward that looks up a
    sharded table (a backward needs none: it runs the recorded collectives)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = cfg
    prev_route = set_lookup_route(None if cfg is None else sharded_lookup)
    try:
        yield cfg
    finally:
        _ACTIVE = prev
        set_lookup_route(prev_route)


def active_partitioning() -> Optional[EmbeddingPartitioning]:
    return _ACTIVE


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids of any shape -> ids.shape + (D,), routed through
    the active EP strategy if it routes ``table``, else the dense lookup."""
    cfg = _ACTIVE
    if cfg is None or not cfg.routes(table):
        return dense_gather_rows(table, ids)
    flat = ids.reshape(-1).contiguous()
    if cfg.strategy == "scatter":
        out = sharded_gather_scatter(table, flat, cfg.mesh)
    else:
        out = sharded_gather(table, flat, cfg.mesh)
    return out.reshape(*ids.shape, table.shape[1])


def is_table_name(name: str) -> bool:
    """Whether a parameter (or pytree path) name ends in an EP table key."""
    return any(name == key or name.endswith("." + key) for key in EP_TABLE_KEYS)


def shard_model_tables(
    params: Mapping[str, torch.Tensor], mesh: DeviceMesh, strategy: str = "psum"
) -> Tuple[Dict[str, torch.Tensor], EmbeddingPartitioning, Dict[str, int]]:
    """This rank's row block of every 2-D EP table of ``params`` (name ->
    tensor, as ``named_parameters`` gives them); the other entries as given.

    Returns ``(params, cfg, orig_heights)``: ``cfg`` is ready for
    :func:`embedding_partitioning`, and ``orig_heights`` maps each sharded
    name to its vocabulary before padding, so :func:`unshard_model_tables`
    restores the exact shapes for serving.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"ep_strategy {strategy!r}: one of {STRATEGIES}")
    m = axis_size(mesh, MODEL_AXIS)
    out, heights, orig = dict(params), set(), {}
    for name, leaf in params.items():
        if leaf.dim() == 2 and is_table_name(name):
            out[name] = shard_table(leaf, mesh)
            orig[name] = leaf.shape[0]
            heights.add(out[name].shape[0] * m)
    cfg = EmbeddingPartitioning(mesh=mesh, strategy=strategy, sharded_heights=frozenset(heights))
    return out, cfg, orig


def unshard_table(block: torch.Tensor, vocab: int, mesh: DeviceMesh) -> torch.Tensor:
    """The whole [vocab, ...] table from every model rank's block: an
    all-gather over the model group, the padding stripped."""
    return collectives.all_gather_tiled(block.detach().contiguous(),
                                        axis_group(mesh, MODEL_AXIS))[:vocab].clone()


def unshard_model_tables(params: Mapping[str, torch.Tensor], orig_heights: Mapping[str, int],
                         mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """Strip vocab padding and replicate -- the dense serving layout."""
    return {name: unshard_table(leaf, orig_heights[name], mesh) if name in orig_heights else leaf
            for name, leaf in params.items()}


def set_parameters(model: nn.Module, params: Mapping[str, torch.Tensor]) -> None:
    """Make each tensor of ``params`` the model's parameter of that name (a row
    block may replace a whole table, and back); a parameter is kept as the
    object it is."""
    for name, t in params.items():
        module_name, _, leaf = name.rpartition(".")
        model.get_submodule(module_name).register_parameter(
            leaf, t if isinstance(t, nn.Parameter) else nn.Parameter(t))
