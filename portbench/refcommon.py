"""What the plain references share: precision, the loss, Adam, and the gaps
that decide ``correct``.

Plain PyTorch only. Nothing here imports the program under test.

Precision: ``"float32"`` is float32 with TF32 off, the precision the
configurations state; ``"tf32"`` is the control, the nearest precision below
it. On a card TF32 is the card's own (``allow_tf32``, for the forward and the
backward alike); on the CPU, which has none, each product's operands are
rounded to TF32's 10-bit mantissa, to nearest, and multiplied in float32.
"""

from __future__ import annotations

import contextlib
import math
from statistics import median
from typing import Callable, Dict, Iterator, List, Sequence

import torch

PRECISIONS = ("float32", "tf32")
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    bias = ((i >> 13) & 1) + 0xFFF
    return ((i + bias) & -8192).view(torch.float32)


class _Tf32MatMul(torch.autograd.Function):
    """2-D ``a @ b`` with every product's operands rounded to TF32, the
    backward's products too."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).T, tf32_round(a).T @ g


def _mm_tf32_emulated(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("the references multiply 2-D operands only")
    return _Tf32MatMul.apply(a, b)


def _mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("the references multiply 2-D operands only")
    return a @ b


@contextlib.contextmanager
def precision(name: str, device: torch.device) -> Iterator[Callable]:
    """Yields the reference's ``mm(a, b)`` in precision ``name``; on a card,
    sets the TF32 switches for the block (forward and backward) and restores
    them after it."""
    if name not in PRECISIONS:
        raise ValueError(f"precision {name!r}: one of {PRECISIONS}")
    tf32 = name == "tf32"
    if torch.device(device).type != "cuda":
        yield _mm_tf32_emulated if tf32 else _mm_plain
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield _mm_plain
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def linear(mm: Callable, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None):
    """``x @ w + b`` for x of any leading shape."""
    y = mm(x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], w.shape[1])
    return y if b is None else y + b


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of sigmoid(logits) against labels."""
    x, y = logits, labels.to(logits.dtype)
    return (torch.clamp(x, min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()


def adam_steps(loss_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
               params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
               steps: int, keep_at: int | None = None) -> Dict[str, object]:
    """``steps`` steps of Adam with L2 weight decay added to the gradient
    (``torch.optim.Adam(lr, weight_decay)``'s rule), from ``params``.

    Returns each step's loss, the first step's gradient as the optimizer gets
    it (``g + weight_decay * p``), the parameters after step ``keep_at``
    (``params_at``, where it is given) and after the last step."""
    b1, b2 = ADAM_BETAS
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses: List[torch.Tensor] = []
    first_grad: Dict[str, torch.Tensor] = {}
    params_at: Dict[str, torch.Tensor] = {}
    for t in range(1, steps + 1):
        loss = loss_fn(p)
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        losses.append(loss.detach())
        with torch.no_grad():
            for (k, x), g in zip(p.items(), grads):
                g = torch.zeros_like(x) if g is None else g
                g = g + weight_decay * x
                if t == 1:
                    first_grad[k] = g.clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v2[k] / (1 - b2 ** t)
                x.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
        if t == keep_at:
            params_at = {k: x.detach().clone() for k, x in p.items()}
    return {"losses": torch.stack(losses).float().cpu().tolist() if losses else [],
            "first_grad": first_grad, "params_at": params_at,
            "params": {k: x.detach() for k, x in p.items()}}


# -- the numbers compared -------------------------------------------------

def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """The largest gap of a step's loss, relative to the reference's."""
    if len(program) != len(reference) or not all(math.isfinite(a) for a in program):
        return float("inf")
    return max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(program, reference))


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              names: Sequence[str] | None = None) -> Dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median leaf's.
    A leaf the program lacks counts as zero."""
    ref = {k: float(v.double().norm()) for k, v in reference.items()}
    mid = median(list(ref.values()))
    out = {}
    for k in (names if names is not None else ref):
        got = program.get(k)
        n = 0.0 if got is None else float(got.double().norm())
        out[k] = float("inf") if n != n else abs(n - ref[k]) / max(ref[k], mid, 1e-30)
    return out


def moved_leaves(first_grad: Dict[str, torch.Tensor], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient norm is at least ``share`` of the
    median leaf's; the others move under Adam by round-off alone."""
    norms = {k: float(v.double().norm()) for k, v in first_grad.items()}
    floor = share * median(list(norms.values()))
    return [k for k, n in norms.items() if n >= floor]


def list_gap(lists: torch.Tensor, ref_scores: torch.Tensor, ref_top: torch.Tensor,
             scale: float) -> float:
    """The widest gap, over users and ranks, by which a served item's
    reference score lies below the reference's own score at that rank,
    against ``scale``. ``ref_scores`` [U, I] has seen items at -inf, so
    serving one reads inf; so do an id out of range and an item listed
    twice. ``ref_top`` [U, k]: the reference's k best scores a user."""
    num_items = ref_scores.shape[1]
    lists = lists.long()
    if lists.shape != ref_top.shape or bool(((lists < 0) | (lists >= num_items)).any()):
        return float("inf")
    s = torch.sort(lists, dim=1).values
    if bool((s[:, 1:] == s[:, :-1]).any()):
        return float("inf")
    served = torch.gather(ref_scores, 1, lists)
    return float((ref_top - served).max()) / scale


def score_gap(scores: torch.Tensor, ref_scores: torch.Tensor, scale: float) -> float:
    """The largest gap of an unseen item's score (``ref_scores`` finite),
    against ``scale``."""
    live = torch.isfinite(ref_scores)
    gap = (scores.double() - ref_scores.double()).abs()[live]
    if gap.numel() and bool(torch.isnan(gap).any()):
        return float("inf")
    return float(gap.max()) / scale if gap.numel() else 0.0
