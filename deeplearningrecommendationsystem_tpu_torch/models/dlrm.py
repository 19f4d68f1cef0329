"""DLRM-DCNv2: dense features and multi-hot bags through a low-rank cross network.

The recommendation model of MLPerf Training (v3.0 on; mlcommons/training
``recommendation_v2/torchrec_dlrm``, after torchrec's ``DLRM_DCN``), which
the JAX package does not have. A row is 13 dense features and, for each of
26 categorical features, a bag of a fixed number of ids into that feature's
table:

* the bottom MLP (13-512-256-128, ReLU after every layer, ``relu_stack``)
  embeds the dense features to D;
* each bag is looked up through ``ops/embedding.py::gather_rows`` (the gather
  kernel on the card) and sum-pooled to D; the hotness is fixed, so pooling
  is a split and a sum (``pool_bags``);
* the dense embedding and the 26 bags, concatenated in that order, give
  x0 [B, 27 D]; three low-rank cross layers (``ops/interactions.py::
  low_rank_cross``, rank 512, bias inside the product) follow;
* the top MLP (27 D-1024-1024-512-256-1, ReLU after all layers but the last,
  ``mlp``) gives the logit.

Parameters, by name: ``tables`` [sum(V_f), D], the 26 tables one after
another (feature f's rows from ``BagSpec.row_offsets[f]``: the table-batched
layout of torchrec's fused embeddings), so that a step looks up, dedups and
updates every table's rows in one call each and the host launches a few
kernels a step, not a few for each table; ``bottom.{i}.{w,b}``,
``cross.{i}.{v,w,b}`` (v [27 D, r], w [r, 27 D], b [27 D]) and
``top.{i}.{w,b}``. Initial weights as torchrec draws them: table f
U(-sqrt(1/V_f), sqrt(1/V_f)), the cross's v and w Xavier-normal and its bias
zero, the MLPs ``linear_init``. The tables are drawn in place on the
``device`` the model is built on, so a card's tables are never made on the
host.

The batch is a dict: ``dense`` [B, 13] float32 and ``ids`` [B, sum(hotness)]
int64, feature f's ids in its fixed slice ``BagSpec.offsets[f]`` onwards (a
float layout such as ``features.py``'s [B, 45] holds ids exactly only up to
2^24, and these tables pass that).

The sparse-row protocol of ``train/sparse_trainer.py`` (``models/mf.py``):
``sparse_tables`` names ``tables``, ``table_ids`` gives a batch's [B * 214]
row numbers in it (each id plus its table's first row) and ``apply_rows``
pools the gathered rows, so ``fit_minibatch_sparse(...,
optimizer="rowwise_adagrad")`` trains every table row-wise and the MLPs and
the cross with the dense Adam.

Spans (``runtime/profiler.py``): ``dlrm.bags``, the 26 bags (in a forward
over full parameters their lookup and sums; in the sparse step, whose lookup
is the trainer's ``train.lookup``, the sums) with the concatenation, and
``dlrm.cross``, the three cross layers.

``DLRM`` is not a preset of ``configs/presets.py``: the presets are the
ml-100k models, and DLRM trains on Criteo-shaped data (the benchmark's
``dlrm-dcnv2-train`` cell draws it at the published shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.models.base import init_generator
from deeplearningrecommendationsystem_tpu_torch.models.common import (
    layer_list,
    nest,
    register_tree,
)
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.interactions import low_rank_cross
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp, mlp_init, relu_stack
from deeplearningrecommendationsystem_tpu_torch.runtime.profiler import span

# MLPerf Training's DLRM-DCNv2 on Criteo 1TB (the reference's README):
# num_embeddings_per_feature and multi_hot_sizes of the 26 categorical features
CRITEO_1TB_ROWS = (40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63, 40000000,
                   3067956, 405282, 10, 2209, 11938, 155, 4, 976, 14, 40000000,
                   40000000, 40000000, 590152, 12973, 108, 36)
CRITEO_1TB_HOTNESS = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27,
                      10, 3, 1, 1)


@dataclasses.dataclass(frozen=True)
class BagSpec:
    """The categorical features: each table's height and each bag's ids a row."""

    heights: Tuple[int, ...]
    hotness: Tuple[int, ...]

    def __post_init__(self):
        if len(self.heights) != len(self.hotness) or not self.heights:
            raise ValueError(f"{len(self.heights)} heights, {len(self.hotness)} hotnesses")
        if min(self.heights) < 1 or min(self.hotness) < 1:
            raise ValueError("every table needs a row and every bag an id")

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Where each feature's ids start in a row of ``ids``."""
        return _starts(self.hotness)

    @property
    def row_offsets(self) -> Tuple[int, ...]:
        """Where each feature's table starts in the model's ``tables``."""
        return _starts(self.heights)


def _starts(sizes: Sequence[int]) -> Tuple[int, ...]:
    out, at = [], 0
    for n in sizes:
        out.append(at)
        at += n
    return tuple(out)


def pool_bags(rows: torch.Tensor) -> torch.Tensor:
    """Sum-pool a feature's gathered rows [B, hotness, D] to [B, D]."""
    return rows.sum(dim=1)


def _tables(generator: torch.Generator, bags: BagSpec, dim: int) -> torch.Tensor:
    """The 26 tables one after another, each U(-sqrt(1/V), sqrt(1/V)), drawn in place."""
    t = torch.empty((sum(bags.heights), dim), dtype=torch.float32, device=generator.device)
    for o, v in zip(bags.row_offsets, bags.heights):
        bound = (1.0 / v) ** 0.5
        t[o:o + v].uniform_(-bound, bound, generator=generator)
    return t


def _xavier_normal(generator: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    std = (2.0 / (d_in + d_out)) ** 0.5
    return std * torch.randn((d_in, d_out), generator=generator, device=generator.device)


class DLRM(nn.Module):
    def __init__(
        self,
        bags: BagSpec,
        embedding_dim: int = 128,
        num_dense: int = 13,
        bottom_units: Sequence[int] = (512, 256, 128),
        top_units: Sequence[int] = (1024, 1024, 512, 256, 1),
        cross_layers: int = 3,
        cross_rank: int = 512,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        if bottom_units[-1] != embedding_dim or top_units[-1] != 1:
            raise ValueError(f"the bottom MLP ends at D ({embedding_dim}), the top at 1: "
                             f"{tuple(bottom_units)}, {tuple(top_units)}")
        generator = init_generator(generator, device)
        self.bags = bags
        d = (len(bags.heights) + 1) * embedding_dim
        # each column of ``ids``: the first row of its feature's table
        base = [o for o, h in zip(bags.row_offsets, bags.hotness) for _ in range(h)]
        self.register_buffer("id_base", torch.tensor(base, device=generator.device),
                             persistent=False)
        register_tree(self, {
            "tables": _tables(generator, bags, embedding_dim),
            "bottom": mlp_init(generator, (num_dense,) + tuple(bottom_units)),
            "cross": [{"v": _xavier_normal(generator, d, cross_rank),
                       "w": _xavier_normal(generator, cross_rank, d),
                       "b": torch.zeros(d, device=generator.device)}
                      for _ in range(cross_layers)],
            "top": mlp_init(generator, (d,) + tuple(top_units)),
        })

    def _interact(self, p: Mapping[str, Any], x0: torch.Tensor) -> torch.Tensor:
        """The cross network and the top MLP over x0 [B, 27 D]: logits [B]."""
        with span("dlrm.cross"):
            x = low_rank_cross(layer_list(p["cross"]), x0)
        return mlp(layer_list(p["top"]), x)[:, 0]

    def _bags(self, dense: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """x0 [B, 27 D]: the dense embedding and every feature's bag of the
        gathered rows [B * 214, D], concatenated."""
        # one split, whose backward writes the rows' gradient once (a slice a
        # feature would fill and add a whole [B, 214, D] gradient for each)
        bags = torch.split(rows.reshape(dense.shape[0], -1, rows.shape[-1]), self.bags.hotness, 1)
        return torch.cat([dense] + [pool_bags(b) for b in bags], dim=-1)

    def apply_params(self, params: Mapping[str, Any], batch: Mapping[str, torch.Tensor]):
        """Logits [B] of ``{"dense": [B, 13], "ids": [B, sum(hotness)]}``."""
        p = nest(params)
        dense = relu_stack(layer_list(p["bottom"]), batch["dense"])
        with span("dlrm.bags"):
            x0 = self._bags(dense, gather_rows(p["tables"], self.table_ids(batch)["tables"]))
        return self._interact(p, x0)

    def forward(self, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        return self.apply_params(dict(self.named_parameters()), batch)

    # -- sparse-row protocol (train/sparse_trainer.py) ----------------------
    sparse_tables = {"tables": "tables"}

    def table_ids(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The batch's rows of ``tables``, [B * 214]: each id plus its table's first row."""
        return {"tables": (batch["ids"] + self.id_base).reshape(-1)}

    def apply_rows(self, dense: Mapping[str, Any], rows: Mapping[str, torch.Tensor],
                   batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """``apply_params`` with the lookup given as ``rows``; ``dense`` is the
        params without the tables."""
        p = nest(dense)
        x = relu_stack(layer_list(p["bottom"]), batch["dense"])
        with span("dlrm.bags"):
            x0 = self._bags(x, rows["tables"])
        return self._interact(p, x0)
