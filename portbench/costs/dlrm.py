"""Operations and bytes of DLRM-DCNv2, from its shapes.

Per row, the forward's products (two operations a multiply-add): the bottom
MLP (13-512-256-128), each cross layer's two products (2 d r + 2 r d at
d = 27 D, rank r) and the top MLP (27 D-1024-1024-512-256-1): 32,060,928 at
the published widths, of which the cross is 21,233,664 (66%). The backward
takes each product twice (the gradients of its two operands), but for the
bottom MLP's first layer, whose input is data with no gradient: 96,169,472 a
row trained, 787.8 GFLOP a step of 8,192 rows. A bag's sum, the cross's
elementwise terms and the biases are not products.

Lookups: a step's gathers (``gather_rows``, ``costs/lookup.py``), each of
its int64 ids into [V, D] float32 rows, the rows its ids touch read once: one
a step, of B * 214 ids into the 26 tables held as one parameter
(``models/dlrm.py``). The row-sparse step forms no table gradient: no
``onehot_grad``.
"""

from __future__ import annotations

from typing import Dict, Sequence

from portbench.costs import lookup


def _mlp(dims: Sequence[int]) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def row_products(config: Dict) -> int:
    """The forward's products of one row."""
    D, r = config["embedding_dim"], config["dcn_low_rank_dim"]
    d = (len(config["multi_hot_sizes"]) + 1) * D
    bottom = [config["num_dense_features"]] + list(config["dense_arch_layer_sizes"])
    return (_mlp(bottom) + config["dcn_num_layers"] * 2 * (2 * d * r)
            + _mlp([d] + list(config["over_arch_layer_sizes"])))


def train_row_products(config: Dict) -> int:
    """One row's products through the forward and the backward."""
    first = 2 * config["num_dense_features"] * config["dense_arch_layer_sizes"][0]
    return 3 * row_products(config) - first


def train_unit(config: Dict, rows: int, lookups: Sequence[Sequence[tuple]]) -> Dict:
    """Products and the lookups' bound of one unit: ``rows`` rows trained,
    and for each step of it each gather's (ids, distinct ids)."""
    D = config["embedding_dim"]
    return {"products": rows * train_row_products(config),
            "bounds": {"lookup": sum(lookup.gather_s(n, D, touched, 8)
                                     for step in lookups for n, touched in step)}}
