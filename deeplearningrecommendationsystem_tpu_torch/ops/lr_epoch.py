"""Fused full-batch LR training: BCE and torch Adam over whole epochs.

Ports the two kernels of the JAX package's ``ops/pallas/lr_epoch.py``:

* ``lr_fullbatch_train(x_aug, y, w0, ...)`` (``mode="wide"``): the LR score is
  ``x_aug @ w`` over the design matrix ``x_aug = [user one-hot, item one-hot,
  dense, 1]`` [B, F]; w0 [F, 1].
* ``lr_fullbatch_train_compact(uid, iid, dense_aug, y, w0, ..., u_pad, i_pad)``
  (``mode="compact"``): the same score from the ids and the dense block,
  ``w[uid] + w[u_pad + iid] + dense_aug . w[u_pad + i_pad:]``, with the weights
  in one segment-padded row w0 [1, u_pad + i_pad + d_pad]. An id matches the
  lane of its segment when it lies in ``[0, u_pad)`` (``[0, i_pad)``), as the
  Pallas kernel's ``iota == id`` mask matches; any other id matches none.
  Lanes no id matches get zero gradient and stay as they are.

Each epoch records the loss before its update (mean sigmoid-BCE-with-logits),
takes g = (sigmoid(z) - y) / B, dw = X^T g, and one torch-Adam step with no
weight decay and bias corrections ``1 - exp(t log b)`` in float32, as the
Pallas kernels compute them. Both return ``(w, losses [epochs])`` in float32,
w in the shape of w0.

Dispatch is by device only: CPU tensors take the plain version, CUDA tensors
launch the kernels (``ops/cuda/lr_epoch.py``: the wide mode two launches an
epoch, the compact mode one launch a call) or raise.
"""

from __future__ import annotations

import torch

from deeplearningrecommendationsystem_tpu_torch.device import on_cpu as _on_cpu
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import lr_epoch as _cuda
from deeplearningrecommendationsystem_tpu_torch.ops.mf_epoch import _bias_correction


def _bce_and_grad(z: torch.Tensor, y: torch.Tensor):
    """(sum of the stable BCE-with-logits, (sigmoid(z) - y) / B)."""
    bce = z.clamp_min(0.0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return bce.sum(), (torch.sigmoid(z) - y) / z.shape[0]


def _adam(w, m, v, dw, step: int, lr: float, b1: float, b2: float, eps: float) -> None:
    """One torch-Adam step in place (no weight decay)."""
    bc1 = _bias_correction(step, b1, w.device)
    bc2 = _bias_correction(step, b2, w.device)
    m.copy_(b1 * m + (1.0 - b1) * dw)
    v.copy_(b2 * v + (1.0 - b2) * dw * dw)
    w.copy_(w - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps))


def lr_fullbatch_train_plain(x_aug, y, w0, epochs: int, learning_rate: float,
                             b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Plain version of :func:`lr_fullbatch_train`."""
    x, y = x_aug.float(), y.reshape(-1).float()
    w = w0.float().clone()
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    losses = torch.zeros(epochs, dtype=torch.float32, device=w.device)
    for e in range(epochs):
        z = (x @ w)[:, 0]
        loss, g = _bce_and_grad(z, y)
        losses[e] = loss / x.shape[0]
        _adam(w, m, v, x.T @ g[:, None], e + 1, learning_rate, b1, b2, eps)
    return w, losses


def lr_fullbatch_train(x_aug, y, w0, epochs: int, learning_rate: float,
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Train ``epochs`` full-batch Adam epochs of LR over the design matrix:
    x_aug [B, F] f32, y [B] f32, w0 [F, 1] f32 -> (w [F, 1], losses [epochs])."""
    if _on_cpu(x_aug, y, w0):
        return lr_fullbatch_train_plain(x_aug, y, w0, epochs, learning_rate, b1, b2, eps)
    return _cuda.lr_fullbatch_train(x_aug, y, w0, epochs, learning_rate, b1, b2, eps)


def lr_fullbatch_train_compact_plain(uid, iid, dense_aug, y, w0, epochs: int,
                                     learning_rate: float, u_pad: int, i_pad: int,
                                     b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Plain version of :func:`lr_fullbatch_train_compact`."""
    B, d_pad = dense_aug.shape
    if tuple(w0.shape) != (1, u_pad + i_pad + d_pad):
        raise ValueError(f"w0 {tuple(w0.shape)} is not [1, u_pad + i_pad + d_pad = "
                         f"{u_pad + i_pad + d_pad}]")
    dense, y = dense_aug.float(), y.reshape(-1).float()
    w = w0.reshape(-1).float().clone()
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    segs = []
    for ids, size in ((uid.long(), u_pad), (iid.long(), i_pad)):
        ok = (ids >= 0) & (ids < size)
        segs.append((ids.clamp(0, size - 1), ok, size))
    (u, u_ok, _), (i, i_ok, _) = segs
    wu, wi, wd = w[:u_pad], w[u_pad:u_pad + i_pad], w[u_pad + i_pad:]  # views of w
    losses = torch.zeros(epochs, dtype=torch.float32, device=w.device)
    for e in range(epochs):
        z = torch.where(u_ok, wu[u], 0.0) + torch.where(i_ok, wi[i], 0.0) + dense @ wd
        loss, g = _bce_and_grad(z, y)
        losses[e] = loss / B
        dw = torch.cat([torch.zeros(size, device=w.device).index_add_(0, ids[ok], g[ok])
                        for ids, ok, size in segs] + [dense.T @ g])
        _adam(w, m, v, dw, e + 1, learning_rate, b1, b2, eps)
    return w.reshape(1, -1), losses


def lr_fullbatch_train_compact(uid, iid, dense_aug, y, w0, epochs: int, learning_rate: float,
                               u_pad: int, i_pad: int, b1: float = 0.9, b2: float = 0.999,
                               eps: float = 1e-8):
    """Train ``epochs`` full-batch Adam epochs of LR from ids and the dense
    block: uid, iid [B] int, dense_aug [B, d_pad] f32 (dense columns, a ones
    column, zero padding), y [B] f32, w0 [1, u_pad + i_pad + d_pad] f32 ->
    (w [1, u_pad + i_pad + d_pad], losses [epochs])."""
    if _on_cpu(uid, iid, dense_aug, y, w0):
        return lr_fullbatch_train_compact_plain(uid, iid, dense_aug, y, w0, epochs,
                                                learning_rate, u_pad, i_pad, b1, b2, eps)
    return _cuda.lr_fullbatch_train_compact(uid, iid, dense_aug, y, w0, epochs, learning_rate,
                                            u_pad, i_pad, b1, b2, eps)
