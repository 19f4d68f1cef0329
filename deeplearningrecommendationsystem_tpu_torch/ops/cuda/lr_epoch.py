"""Checked launchers of the fused LR training kernels (``csrc/lr_epoch.cu``).

``lr_fullbatch_train`` (mode "wide") checks its inputs, allocates the
weights, the Adam moments, the per-block partial sums and the loss history,
then launches two kernels per epoch on the current stream (the epoch's
forward and backward, then the reduction of its partial sums with the Adam
step), with no synchronisation between epochs.

``lr_fullbatch_train_compact`` (mode "compact") checks its inputs, builds
each id's rows (``ops/segments.py::id_segments``, once a call), allocates the
weights, the loss history and one workspace, and makes one cooperative launch
of ``lr_compact_train_kernel`` for the whole run. Its grid is every block the
card keeps resident at once; a grid that cannot be resident makes the launch
fail and the launcher raise.

Each keeps a count of its launches (``.launches``), raised by one per kernel
launch: two an epoch in the wide mode, one a call in the compact mode.

The library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build
from deeplearningrecommendationsystem_tpu_torch.ops.cuda.launch import (
    LL,
    F,
    I,
    P,
    check,
    raise_on,
    require_cuda,
    stream,
)
from deeplearningrecommendationsystem_tpu_torch.ops.segments import id_segments

SOURCE = "lr_epoch.cu"
MAX_TILE_ROWS = 16  # kMaxTileRows in the source
MAX_DENSE = 128  # kMaxDense in the source
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper
ID_DTYPES = (torch.int32, torch.int64)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.lr_wide_epoch.argtypes = [P, P, P, P, P, LL, I, I, I, P]
    lib.lr_wide_epoch.restype = I
    lib.lr_compact_train.argtypes = [P] * 12 + [LL, I, I, I, I] + [F] * 8 + [I, I, P]
    lib.lr_compact_train.restype = I
    lib.lr_compact_grid.argtypes = [I]
    lib.lr_compact_grid.restype = I
    lib.lr_compact_workspace_bytes.argtypes = [LL, I, I, I]
    lib.lr_compact_workspace_bytes.restype = ctypes.c_size_t
    lib.lr_adam.argtypes = [P, P, P, P, I, P, I, P, I, P, LL] + [F] * 8 + [I, P]
    lib.lr_adam.restype = I
    lib.lr_wide_smem_bytes.argtypes = [I, I]
    lib.lr_wide_smem_bytes.restype = ctypes.c_size_t
    lib.lr_epoch_error_string.argtypes = [I]
    lib.lr_epoch_error_string.restype = ctypes.c_char_p
    for name, want in (("lr_epoch_max_tile_rows", MAX_TILE_ROWS), ("lr_epoch_max_dense", MAX_DENSE)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], I
        if fn() != want:
            raise RuntimeError(f"lr_epoch.cu and its launcher disagree on {name}")
    return lib


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _compact_grid(index: int, d_pad: int) -> int:
    """Blocks of one compact launch on device ``index``: all it keeps resident."""
    with torch.cuda.device(index):
        blocks = _lib().lr_compact_grid(d_pad)
    if blocks < 1:
        raise RuntimeError(f"lr_fullbatch_train_compact: no resident grid for d_pad={d_pad}")
    return blocks


def _hyper(learning_rate, b1, b2, eps):
    return (learning_rate, b1, 1.0 - b1, b2, 1.0 - b2, eps, math.log(b1), math.log(b2))


def _adam(lib, w, m, v, part, n_dense, loss_part, losses, e, B, hyper, s, name):
    """lr_adam_kernel over the dense weights alone (no id gradient section)."""
    code = lib.lr_adam(w.data_ptr(), m.data_ptr(), v.data_ptr(), None, 0, part.data_ptr(),
                       n_dense, loss_part.data_ptr(), loss_part.shape[0], losses[e:].data_ptr(),
                       B, *hyper, e + 1, s)
    raise_on(lib.lr_epoch_error_string, code, f"{name} (adam)")


def lr_fullbatch_train(x_aug, y, w0, epochs: int, learning_rate: float,
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Launch ``epochs`` x (``lr_wide_epoch_kernel``, ``lr_adam_kernel``):
    x_aug [B, F] f32, y [B] f32, w0 [F, 1] f32 -> (w [F, 1], losses [epochs])."""
    device = x_aug.device
    require_cuda("lr_fullbatch_train", device)
    check("x_aug", x_aug, (torch.float32,), 2, device)
    check("y", y, (torch.float32,), 1, device)
    check("w0", w0, (torch.float32,), 2, device)
    B, Fw = x_aug.shape
    if y.shape[0] != B or tuple(w0.shape) != (Fw, 1):
        raise ValueError(f"shapes x_aug {tuple(x_aug.shape)}, y {tuple(y.shape)}, "
                         f"w0 {tuple(w0.shape)}")
    if B < 1 or Fw < 1 or epochs < 0:
        raise ValueError(f"need B={B} >= 1, F={Fw} >= 1, epochs >= 0")
    lib = _lib()
    R = MAX_TILE_ROWS
    while R > 0 and lib.lr_wide_smem_bytes(Fw, R) > SMEM_LIMIT:
        R -= 1
    if R < 1:
        raise ValueError(f"F={Fw} columns: one row does not fit in a block's shared memory")
    blocks = min(-(-B // R), _sm_count(device))
    w = w0.clone()
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    dw_part = torch.empty((blocks, Fw), dtype=torch.float32, device=device)
    loss_part = torch.empty(blocks, dtype=torch.float32, device=device)
    losses = torch.zeros(epochs, dtype=torch.float32, device=device)
    hyper = _hyper(learning_rate, b1, b2, eps)
    with torch.cuda.device(device):
        s = stream(device.index)
        for e in range(epochs):
            code = lib.lr_wide_epoch(x_aug.data_ptr(), y.data_ptr(), w.data_ptr(),
                                     dw_part.data_ptr(), loss_part.data_ptr(), B, Fw, R, blocks, s)
            raise_on(lib.lr_epoch_error_string, code, "lr_fullbatch_train (epoch)")
            lr_fullbatch_train.launches += 1
            _adam(lib, w, m, v, dw_part, Fw, loss_part, losses, e, B, hyper, s,
                  "lr_fullbatch_train")
            lr_fullbatch_train.launches += 1
    return w, losses


def lr_fullbatch_train_compact(uid, iid, dense_aug, y, w0, epochs: int, learning_rate: float,
                               u_pad: int, i_pad: int, b1: float = 0.9, b2: float = 0.999,
                               eps: float = 1e-8):
    """Launch ``lr_compact_train_kernel`` once for ``epochs`` epochs:
    uid, iid [B] int32/int64, dense_aug [B, d_pad] f32, y [B] f32,
    w0 [1, u_pad + i_pad + d_pad] f32 -> (w [1, u_pad + i_pad + d_pad], losses [epochs])."""
    device = dense_aug.device
    require_cuda("lr_fullbatch_train_compact", device)
    check("uid", uid, ID_DTYPES, 1, device)
    check("iid", iid, (uid.dtype,), 1, device)
    check("dense_aug", dense_aug, (torch.float32,), 2, device)
    check("y", y, (torch.float32,), 1, device)
    check("w0", w0, (torch.float32,), 2, device)
    B, d_pad = dense_aug.shape
    if uid.shape[0] != B or iid.shape[0] != B or y.shape[0] != B:
        raise ValueError(f"shapes uid {tuple(uid.shape)}, iid {tuple(iid.shape)}, "
                         f"dense_aug {tuple(dense_aug.shape)}, y {tuple(y.shape)}")
    if tuple(w0.shape) != (1, u_pad + i_pad + d_pad):
        raise ValueError(f"w0 {tuple(w0.shape)} is not [1, u_pad + i_pad + d_pad = "
                         f"{u_pad + i_pad + d_pad}]")
    if B < 1 or u_pad < 1 or i_pad < 1 or not 1 <= d_pad <= MAX_DENSE or epochs < 0:
        raise ValueError(f"need B={B}, u_pad={u_pad}, i_pad={i_pad} >= 1, "
                         f"1 <= d_pad={d_pad} <= {MAX_DENSE}, epochs >= 0")
    lib = _lib()
    n = u_pad + i_pad + d_pad
    with torch.cuda.device(device):
        order_u, off_u = id_segments(uid, u_pad)
        order_i, off_i = id_segments(iid, i_pad)
        blocks = _compact_grid(device.index, d_pad)
        work = torch.empty(lib.lr_compact_workspace_bytes(B, n, d_pad, blocks),
                           dtype=torch.uint8, device=device)
        w = torch.empty_like(w0)
        losses = torch.empty(epochs, dtype=torch.float32, device=device)
        code = lib.lr_compact_train(
            uid.data_ptr(), iid.data_ptr(), order_u.data_ptr(), off_u.data_ptr(),
            order_i.data_ptr(), off_i.data_ptr(), dense_aug.data_ptr(), y.data_ptr(),
            w0.data_ptr(), w.data_ptr(), losses.data_ptr(), work.data_ptr(), B, u_pad, i_pad,
            d_pad, epochs, *_hyper(learning_rate, b1, b2, eps), uid.element_size(), blocks,
            stream(device.index))
        raise_on(lib.lr_epoch_error_string, code, "lr_fullbatch_train_compact")
        lr_fullbatch_train_compact.launches += 1
    return w, losses


lr_fullbatch_train.launches = 0
lr_fullbatch_train_compact.launches = 0
