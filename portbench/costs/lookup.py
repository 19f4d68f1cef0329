"""Operations and bytes of the lookup pair: ``gather_rows`` (``table[ids]``)
and ``onehot_grad`` (the table's gradient: the rows of ``g`` summed into a
zeroed [V, D] table at ``ids``).

Bytes: each input read once, each output written once. The gather reads
only the table rows its ids touch (``touched``), its ids, and writes its
[N, D] output; ``onehot_grad`` reads its ids and ``g`` [N, D] and writes the
whole [V, D] gradient, and adds N * D numbers.
"""

from __future__ import annotations

from portbench.peaks import bound_s


def gather_s(n: int, d: int, touched: int, id_bytes: int, elem: int = 4) -> float:
    return bound_s(0, 0, n * d * elem + n * id_bytes + touched * d * elem)


def onehot_grad_s(n: int, d: int, vocab: int, id_bytes: int, elem: int = 4) -> float:
    return bound_s(0, n * d, n * id_bytes + n * d * elem + vocab * d * elem)
