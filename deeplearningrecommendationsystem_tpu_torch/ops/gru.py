"""GRU and AUGRU over behaviour sequences (the JAX package's ``ops/gru.py``).

DIEN's interest-evolution layer is a plain GRU in the reference
(model/dien.py:47,61); ``augru`` is the DIEN paper's attention-update-gate
GRU, the JAX package's extension. Both keep the JAX layout and equations, so
the JAX params carry across as they stand (``weights.py``):

* ``w_ih [d_in, 3H]``, ``w_hh [H, 3H]``, ``b_ih [3H]``, ``b_hh [3H]``; gate
  order r, z, n, as torch's GRU equations, but not ``torch.nn.GRU``'s
  ``[3H, d_in]`` layout;
* ``n = tanh(i_n + r * h_n)``, where ``h_n`` already holds ``b_hh``'s n slice;
* the input projection ``xs @ w_ih + b_ih`` is one [B, L, 3H] product ahead
  of the loop; only ``h @ w_hh + b_hh`` runs per step.

The JAX ``lax.scan`` is a Python loop over L here: plain torch, no kernel
(XLA-only code in the JAX package). The carry ``h`` has the inputs' dtype.
Under bf16 the gates' sigmoid is ``jax.nn.sigmoid``'s own lowering,
``1 / (1 + exp(-x))`` with each op's result rounded to bf16, since
``torch.sigmoid`` rounds once and so lands a third of the gates one bf16 ulp
from the JAX package's; in float32 the two agree to an ulp and
``torch.sigmoid`` is one launch instead of four.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from deeplearningrecommendationsystem_tpu_torch.ops.linear import uniform


def gru_init(generator: torch.Generator, d_in: int, d_hidden: int,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """U(-1/sqrt(H), 1/sqrt(H)) for every weight and bias (torch's GRU default)."""
    bound = 1.0 / (d_hidden ** 0.5)
    return {
        "w_ih": uniform(generator, (d_in, 3 * d_hidden), bound, dtype),
        "w_hh": uniform(generator, (d_hidden, 3 * d_hidden), bound, dtype),
        "b_ih": uniform(generator, (3 * d_hidden,), bound, dtype),
        "b_hh": uniform(generator, (3 * d_hidden,), bound, dtype),
    }


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    if x.dtype == torch.bfloat16:
        return 1.0 / (1.0 + torch.exp(-x))
    return torch.sigmoid(x)


def _gates_from(p: Mapping[str, torch.Tensor], gi: torch.Tensor,
                h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z, n) from a step's precomputed input projection ``gi`` [B, 3H] and
    the carry ``h`` [B, H]."""
    H = h.shape[-1]
    gh = h @ p["w_hh"] + p["b_hh"]
    # r and z in one elementwise pass over their [B, 2H] block: the same values
    # as two, in half the launches (a step is host-bound on a card)
    rz = _sigmoid(gi[..., :2 * H] + gh[..., :2 * H])
    r, z = rz[..., :H], rz[..., H:]
    n = torch.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
    return z, n


def _start(p, xs, h0):
    if h0 is None:
        h0 = torch.zeros((xs.shape[0], p["w_hh"].shape[0]), dtype=xs.dtype, device=xs.device)
    return h0, xs @ p["w_ih"] + p["b_ih"]  # hoisted input projection [B, L, 3H]


def gru(p: Mapping[str, torch.Tensor], xs: torch.Tensor, h0: Optional[torch.Tensor] = None,
        return_sequence: bool = False) -> torch.Tensor:
    """A GRU over xs [B, L, D]: the final state [B, H], or every step's state
    [B, L, H] with ``return_sequence`` (DIEN's auxiliary loss and full-history
    serving read them)."""
    h, gis = _start(p, xs, h0)
    states = []
    for t in range(xs.shape[1]):
        z, n = _gates_from(p, gis[:, t], h)
        h = (1.0 - z) * n + z * h
        states.append(h)
    return torch.stack(states, dim=1) if return_sequence else h


def augru(p: Mapping[str, torch.Tensor], xs: torch.Tensor, att: torch.Tensor,
          h0: Optional[torch.Tensor] = None, return_sequence: bool = False) -> torch.Tensor:
    """AUGRU: the update gate scaled by the attention score a_t. xs [B, L, D],
    att [B, L] -> the final state [B, H], or [B, L, H] with
    ``return_sequence``. Where a_t is 0 the state is held."""
    h, gis = _start(p, xs, h0)
    states = []
    for t in range(xs.shape[1]):
        z, n = _gates_from(p, gis[:, t], h)
        z = att[:, t, None] * z
        h = (1.0 - z) * h + z * n
        states.append(h)
    return torch.stack(states, dim=1) if return_sequence else h
