"""Id-table lookup with a kernel in both directions, and the field embeddings
of the feature-vector family.

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

An EP scope (``parallel/ep.py::embedding_partitioning``, which the Trainer
opens over a mesh) registers its lookup with :func:`set_lookup_route`; while
it is open every ``gather_rows`` call goes through it, and a lookup into a
row-sharded table runs the same kernel pair on the rank's own row block and
a collective over the model group. With no route registered every lookup is
the dense one.

``init_field_tables`` and ``embed_fields`` embed the six ml-100k fields of a
[B, 45] feature matrix: the user and item ids through ``gather_rows`` (the
kernel pair), the age scalar and the gender, occupation and genre blocks as
``x @ table`` products, which the JAX package leaves to XLA and the port to
``torch.matmul``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.ops.gather import gather_rows_kernel, onehot_grad
from deeplearningrecommendationsystem_tpu_torch.ops.linear import embedding_init


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


# the lookup every gather_rows call takes instead of the dense one; None =
# the dense lookup (parallel/ep.py::embedding_partitioning registers its own)
_route = None


def set_lookup_route(route):
    """Make ``route(table, ids) -> rows`` the lookup of every
    :func:`gather_rows` call (None: the dense one); returns the route it
    replaces."""
    global _route
    prev, _route = _route, route
    return prev


def dense_gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids of any shape -> ids.shape + (D,), through the
    kernel pair."""
    out = GatherRows.apply(table, ids.reshape(-1).contiguous())
    return out.reshape(*ids.shape, table.shape[1])


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids of any shape -> ids.shape + (D,), through the
    registered route if there is one."""
    if _route is not None:
        return _route(table, ids)
    return dense_gather_rows(table, ids)


def init_field_tables(
    generator: torch.Generator,
    spec: FeatureSpec,
    dim: int,
    fields: Sequence[str] = ("user", "item", "gender", "occupation", "genre"),
    dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Xavier-normal tables for the requested fields ('age' has vocab 1)."""
    sizes = {
        "user": spec.num_users,
        "item": spec.num_items,
        "age": 1,
        "gender": spec.num_genders,
        "occupation": spec.num_occupations,
        "genre": spec.num_genres,
    }
    return {f: embedding_init(generator, sizes[f], dim, dtype) for f in fields}


def embed_fields(tables: Mapping[str, torch.Tensor], x: torch.Tensor,
                 spec: FeatureSpec) -> Dict[str, torch.Tensor]:
    """Embed each field of a [B, 45] feature matrix -> dict of [B, D] tensors.

    Only fields present in ``tables`` are embedded; 'age' (vocab-1 table)
    projects the scalar age through its single row. The feature matrix stays
    float32 (its id columns); a dense block is cast to its table's dtype where
    they meet, as the JAX trainer's cast of the whole matrix leaves it.
    """
    user, item, age, gender, occupation, genre = spec.split(x)
    blocks = {"age": age, "gender": gender, "occupation": occupation, "genre": genre}
    out: Dict[str, torch.Tensor] = {}
    for name in ("user", "item", "age", "gender", "occupation", "genre"):
        if name not in tables:
            continue
        if name in ("user", "item"):
            out[name] = gather_rows(tables[name], user if name == "user" else item)
        else:
            out[name] = blocks[name].to(tables[name].dtype) @ tables[name]
    return out


def bias_embedding_init(generator: torch.Generator, num: int,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[num, 1] Xavier-normal bias table (the reference's 1-dim id embeddings
    of every wide/linear part)."""
    return embedding_init(generator, num, 1, dtype)
