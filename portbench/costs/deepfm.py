"""Operations and bytes of DeepFM, from its shapes.

Per row, the forward's products (two operations a multiply-add): the four
dense field blocks times their tables (2 (1 + 2 + 21 + 19) D), the linear
part over the 43 dense columns (2 x 43), the tower (2 (6D H0 + H0 H1 + ...))
and the final layer over [FM, deep] (2 x 2). The backward takes the tower's
and the final layer's products twice (the gradients of both operands) and
the field blocks' and the linear part's once (their inputs are data, with no
gradient). The FM term's sums are not products. Lookups: the user and item
tables ([V, D]) and their bias tables ([V, 1]), four a forward, with int64
ids from the feature rows; four ``onehot_grad`` a backward.
"""

from __future__ import annotations

from typing import Dict

from portbench.costs import lookup

DENSE_IN = 1 + 2 + 21 + 19  # age, gender, occupation, genres: the blocks times tables
WIDE_IN = 43


def _widths(config: Dict):
    kw = config["model_kwargs"]
    return kw["embedding_dim"], list(kw["hidden_units"])


def _tower(D: int, H) -> int:
    dims = [6 * D] + list(H)
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:])) + 2 * 2 * 1


def row_products(D: int, H) -> int:
    """The forward's products of one row."""
    return 2 * DENSE_IN * D + 2 * WIDE_IN + _tower(D, H)


def train_row_products(D: int, H) -> int:
    """One row's products through the forward and the backward."""
    return 2 * (2 * DENSE_IN * D + 2 * WIDE_IN) + 3 * _tower(D, H)


def _lookups(x, D: int, spec: Dict):
    u, i = x[:, 0].long(), x[:, 1].long()
    n = x.shape[0]
    tu, ti = int(u.unique().numel()), int(i.unique().numel())
    fwd = sum(lookup.gather_s(n, d, t, 8) for d, t in ((D, tu), (D, ti), (1, tu), (1, ti)))
    bwd = sum(lookup.onehot_grad_s(n, d, v, 8) for d, v in (
        (D, spec["num_users"]), (D, spec["num_items"]), (1, spec["num_users"]),
        (1, spec["num_items"])))
    return fwd, bwd


def train_unit(config: Dict, batches: Dict, epochs: int, track: bool) -> Dict:
    """Products and kernel bounds of one ``Trainer.fit`` of ``epochs`` epochs
    on ``batches`` ({split: (x [B, 45], labels)}): per epoch the train split's
    forward and backward and, with ``track``, the valid and test forwards;
    with ``track``, once more a forward of each split for the final AUCs."""
    D, H = _widths(config)
    fx = config["fixture"]
    evals = ("valid", "test") if track else ()
    rows = {s: batches[s][0].shape[0] for s in ("train",) + evals}
    look = {s: _lookups(batches[s][0], D, fx) for s in rows}
    epoch_products = rows["train"] * train_row_products(D, H) + sum(
        rows[s] * row_products(D, H) for s in evals)
    epoch_lookup = look["train"][0] + look["train"][1] + sum(look[s][0] for s in evals)
    once = list(rows) if track else []
    return {
        "products": epochs * epoch_products + sum(rows[s] * row_products(D, H) for s in once),
        "bounds": {"lookup": epochs * epoch_lookup + sum(look[s][0] for s in once)},
    }


def refresh(config: Dict, inputs: Dict) -> Dict:
    """Products of scoring every (user, item) pair once."""
    D, H = _widths(config)
    return {"products": inputs["num_users"] * inputs["num_items"] * row_products(D, H)}
