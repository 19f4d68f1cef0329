"""Operations and bytes of DIN, from its shapes.

Per row of a window of L positions, embedding D, attention (A1, A2, 1) and
head (F1, F2, 1), the forward's products (two operations a multiply-add):
the activation unit's first layer split as ``h @ (W_a + W_b) + t @ (W_c -
W_b)``, the least work that computes it (2 D A1 for the target once, 2 D A1
a position), its second layer and score (2 A1 A2 + 2 A2 a position), and the
head (2 (2D) F1 + 2 F1 F2 + 2 F2). The backward takes each product twice (the
gradients of its two operands). Other operations, at the CUDA cores' rate:
per position the target term, bias and ReLU (3 A1 + 2 A2), the softmax
(4 L a row) and the pool (2 L D a row); the head's biases and ReLUs
(2 F1 + 4 F2 + 1) and the last attention bias (L); the backward adds the
pool's (4 L D), per position 6 A1 + 5 A2 + 6 D and per row 6 F1 + 4 F2 +
6 D. Bytes of the head (the ``din_*`` kernels): the embedded window, the
target and the weights read once, the logits written; the backward also
reads the logits' gradient and writes the gradients of its inputs and
weights.

Shape arithmetic after ``chip_smoke.py::din_work``, with each product counted
once (not three times where the kernels split it into three TF32 products)
and the backward's recompute of the forward left out: the least work, not the
work one implementation does.
"""

from __future__ import annotations

from typing import Dict, Sequence

from portbench.costs import lookup
from portbench.peaks import bound_s


def _widths(config: Dict):
    kw = config["model_kwargs"]
    return kw["embed_size"], config["hist_len"], tuple(kw["attention_units"]), tuple(kw["fc_units"])


def position_products(D: int, A: Sequence[int]) -> int:
    """Products of one history position in the activation unit."""
    return 2 * D * A[0] + 2 * A[0] * A[1] + 2 * A[1]


def pair_products(D: int, A: Sequence[int], F: Sequence[int]) -> int:
    """Products of one (history, target) pair outside its positions: the
    target's term in the first layer, and the head."""
    return 2 * D * A[0] + 2 * (2 * D) * F[0] + 2 * F[0] * F[1] + 2 * F[1]


def row_products(D: int, L: int, A: Sequence[int], F: Sequence[int]) -> int:
    """The forward's products of one row of L positions."""
    return L * position_products(D, A) + pair_products(D, A, F)


def _weights(D, A, F) -> int:
    return (3 * D * A[0] + A[0] + A[0] * A[1] + A[1] + A[1] + 1
            + 2 * D * F[0] + F[0] + F[0] * F[1] + F[1] + F[1] + 1)


def head_fwd_s(B: int, D: int, L: int, A, F) -> float:
    others = B * (L * (3 * A[0] + 2 * A[1]) + 4 * L + 2 * L * D + 2 * F[0] + 4 * F[1] + 1 + L)
    nbytes = 4 * (B * L * D + B * D + _weights(D, A, F) + B)
    return bound_s(B * row_products(D, L, A, F), others, nbytes)


def head_bwd_s(B: int, D: int, L: int, A, F) -> float:
    others = B * (4 * L * D + L * (6 * A[0] + 5 * A[1] + 6 * D) + 6 * F[0] + 4 * F[1] + 6 * D)
    inputs = B * L * D + B * D + _weights(D, A, F) + B
    return bound_s(2 * B * row_products(D, L, A, F), others, 4 * (2 * inputs - B))


def train_unit(config: Dict, batches: Dict, epochs: int, track: bool) -> Dict:
    """Products and kernel bounds of one ``Trainer.fit`` of ``epochs`` epochs
    on ``batches`` ({split: ((hist [B, L], target [B]), labels)}): per epoch
    the train split's forward and backward, and with ``track`` the valid and
    test splits' forwards; with ``track``, once more a forward of each split
    for the final AUCs. Two lookups a forward (the window, the target), two
    ``onehot_grad`` a backward."""
    D, L, A, F = _widths(config)
    hist, target = batches["train"][0]
    vocab = config["fixture"]["num_items"]
    evals = ("valid", "test") if track else ()

    def fwd(split):
        (h, t), _ = batches[split]
        B = t.shape[0]
        gathers = (lookup.gather_s(h.numel(), D, int(h.unique().numel()), h.element_size())
                   + lookup.gather_s(B, D, int(t.unique().numel()), t.element_size()))
        return B * row_products(D, L, A, F), head_fwd_s(B, D, L, A, F), gathers

    B = target.shape[0]
    bwd = (2 * B * row_products(D, L, A, F), head_bwd_s(B, D, L, A, F),
           lookup.onehot_grad_s(hist.numel(), D, vocab, hist.element_size())
           + lookup.onehot_grad_s(B, D, vocab, target.element_size()))
    epoch = [fwd("train"), bwd] + [fwd(s) for s in evals]
    once = [fwd(s) for s in ("train",) + evals] if track else []
    total = [sum(part[i] for part in epoch) * epochs + sum(part[i] for part in once)
             for i in range(3)]
    return {"products": total[0], "bounds": {"din_head": total[1], "lookup": total[2]}}


def refresh(config: Dict, inputs: Dict) -> Dict:
    """Products of scoring every item against each user's complete history
    (one position a rating in ``inputs``), its real positions only."""
    D, _, A, F = _widths(config)
    num_items = inputs["num_items"]
    positions = len(inputs["users"]) * num_items
    pairs = inputs["num_users"] * num_items
    return {"products": positions * position_products(D, A) + pairs * pair_products(D, A, F)}
