"""Whole-run fused MF training: full-batch epochs of BCE and torch Adam.

Ports the JAX package's ``ops/pallas/mf_epoch.py::mf_fullbatch_train``. Each
epoch gathers the user and item factors of every (user, item, label) row,
computes the pre-update BCE-with-logits loss, its gradient through the
gathers, and one torch-Adam step (classic L2 added to the gradient before the
moments, bias corrections ``1 - exp(t log b)``) on float32 master tables. The
forward and backward run in ``compute_dtype``: "bfloat16" rounds the masters
to bf16 for the gathers and each gradient row ``g * emb`` to bf16 before the
float32 sums, as the Pallas kernel's casts do; "float32" rounds nothing.

Returns ``(pu [U, D], pi [I, D], losses [epochs])``, float32, with
``losses[e]`` the loss before epoch e's update. An id outside ``[0, V)``
matches no row (zero embedding, no gradient), as the Pallas one-hot mask
matches none.

Dispatch is by device only: CPU tensors take the plain version, CUDA tensors
launch the kernels (``ops/cuda/mf_epoch.py``: two launches per epoch) or
raise.
"""

from __future__ import annotations

import math

import torch

from deeplearningrecommendationsystem_tpu_torch.device import on_cpu as _on_cpu
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as _cuda


def _bias_correction(step: int, beta: float, device) -> torch.Tensor:
    """``1 - exp(t log b)`` in float32, as the Pallas kernel computes it."""
    t = torch.tensor(float(step), dtype=torch.float32, device=device)
    return 1.0 - torch.exp(t * math.log(beta))


def mf_fullbatch_train_plain(uid, iid, y, pu0, pi0, epochs: int, learning_rate: float,
                             weight_decay: float = 0.0, compute_dtype: str = "bfloat16",
                             b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Plain version of :func:`mf_fullbatch_train`."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute_dtype!r}: 'float32' or 'bfloat16'")
    if compute_dtype == "bfloat16":
        def cd(x):
            return x.to(torch.bfloat16).float()
    else:
        def cd(x):
            return x

    B = uid.shape[0]
    uid, iid, y = uid.long(), iid.long(), y.float()
    tables = []
    for ids, p0 in ((uid, pu0), (iid, pi0)):
        ok = (ids >= 0) & (ids < p0.shape[0])
        p = p0.float().clone()
        tables.append([ids.clamp(0, p0.shape[0] - 1), ok, p, torch.zeros_like(p),
                       torch.zeros_like(p)])
    losses = torch.zeros(epochs, dtype=torch.float32, device=pu0.device)
    for e in range(epochs):
        (u, u_ok, pu, _, _), (i, i_ok, pi, _, _) = tables
        ue = torch.where(u_ok[:, None], cd(pu)[u], 0.0)
        ie = torch.where(i_ok[:, None], cd(pi)[i], 0.0)
        z = (ue * ie).sum(dim=1)
        bce = z.clamp_min(0.0) - z * y + torch.log1p(torch.exp(-z.abs()))
        losses[e] = bce.sum() / B
        g = ((torch.sigmoid(z) - y) / B)[:, None]
        bc1 = _bias_correction(e + 1, b1, pu.device)
        bc2 = _bias_correction(e + 1, b2, pu.device)
        for (ids, ok, p, m, v), other in ((tables[0], ie), (tables[1], ue)):
            d = torch.zeros_like(p).index_add_(0, ids[ok], cd(g * other)[ok])
            dw = d + weight_decay * p
            m.copy_(b1 * m + (1.0 - b1) * dw)
            v.copy_(b2 * v + (1.0 - b2) * dw * dw)
            p.copy_(p - learning_rate * (m / bc1) / (torch.sqrt(v / bc2) + eps))
    return tables[0][2], tables[1][2], losses


def mf_fullbatch_train(uid, iid, y, pu0, pi0, epochs: int, learning_rate: float,
                       weight_decay: float = 0.0, compute_dtype: str = "bfloat16",
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Train ``epochs`` full-batch Adam epochs; uid, iid [B] int, y [B] f32,
    pu0 [U, D], pi0 [I, D] f32 -> (pu, pi, losses [epochs])."""
    if _on_cpu(uid, iid, y, pu0, pi0):
        return mf_fullbatch_train_plain(uid, iid, y, pu0, pi0, epochs, learning_rate,
                                        weight_decay, compute_dtype, b1, b2, eps)
    return _cuda.mf_fullbatch_train(uid, iid, y, pu0, pi0, epochs, learning_rate,
                                    weight_decay, compute_dtype, b1, b2, eps)
