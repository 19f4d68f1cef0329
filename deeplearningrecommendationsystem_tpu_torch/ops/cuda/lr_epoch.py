"""Checked launchers of the fused LR training kernels (``csrc/lr_epoch.cu``).

``lr_fullbatch_train`` (mode "wide") and ``lr_fullbatch_train_compact``
(mode "compact") check their inputs, allocate the weights, the Adam moments,
the per-block partial sums and the loss history, then launch two kernels per
epoch on the current stream (the epoch's forward and backward, then the
reduction of its partial sums with the Adam step), with no synchronisation
between epochs. Each keeps a count of its launches (``.launches``), raised by
one per kernel launch: two per epoch.

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

SOURCE = "lr_epoch.cu"
MAX_TILE_ROWS = 16  # kMaxTileRows in the source
MAX_DENSE = 128  # 32 lanes x kMaxDenseColsPerLane
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper
COMPACT_WARPS = 8  # kCompactWarps: warps of a compact-kernel block
COMPACT_ROWS_PER_WARP = 16  # the compact kernel's grid gives each warp at least this many rows
ID_DTYPES = (torch.int32, torch.int64)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.lr_wide_epoch.argtypes = [P, P, P, P, P, LL, I, I, I, P]
    lib.lr_wide_epoch.restype = I
    lib.lr_compact_epoch.argtypes = [P, P, P, P, P, P, P, P, LL, I, I, I, I, I, P]
    lib.lr_compact_epoch.restype = I
    lib.lr_adam.argtypes = [P, P, P, P, I, P, I, P, I, P, LL] + [F] * 8 + [I, P]
    lib.lr_adam.restype = I
    lib.lr_wide_smem_bytes.argtypes = [I, I]
    lib.lr_wide_smem_bytes.restype = ctypes.c_size_t
    lib.lr_compact_smem_bytes.argtypes = [I, I, I]
    lib.lr_compact_smem_bytes.restype = ctypes.c_size_t
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


def _hyper(learning_rate, b1, b2, eps):
    return (learning_rate, b1, 1.0 - b1, b2, 1.0 - b2, eps, math.log(b1), math.log(b2))


def _adam(lib, w, m, v, dg, n_sparse, part, n_dense, loss_part, losses, e, B, hyper, s, name):
    code = lib.lr_adam(w.data_ptr(), m.data_ptr(), v.data_ptr(), dg, n_sparse, part.data_ptr(),
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
            _adam(lib, w, m, v, None, 0, dw_part, Fw, loss_part, losses, e, B, hyper, s,
                  "lr_fullbatch_train")
            lr_fullbatch_train.launches += 1
    return w, losses


def lr_fullbatch_train_compact(uid, iid, dense_aug, y, w0, epochs: int, learning_rate: float,
                               u_pad: int, i_pad: int, b1: float = 0.9, b2: float = 0.999,
                               eps: float = 1e-8):
    """Launch ``epochs`` x (``lr_compact_epoch_kernel``, ``lr_adam_kernel``):
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
    if lib.lr_compact_smem_bytes(u_pad, i_pad, d_pad) > SMEM_LIMIT:
        raise ValueError(f"u_pad + i_pad = {u_pad + i_pad} bins do not fit in shared memory")
    blocks = max(1, min(-(-B // (COMPACT_WARPS * COMPACT_ROWS_PER_WARP)), 4 * _sm_count(device)))
    nbins = u_pad + i_pad
    w = w0.clone()
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    dg = torch.zeros(nbins, dtype=torch.float32, device=device)
    dense_part = torch.empty((blocks, d_pad), dtype=torch.float32, device=device)
    loss_part = torch.empty(blocks, dtype=torch.float32, device=device)
    losses = torch.zeros(epochs, dtype=torch.float32, device=device)
    hyper = _hyper(learning_rate, b1, b2, eps)
    with torch.cuda.device(device):
        s = stream(device.index)
        for e in range(epochs):
            code = lib.lr_compact_epoch(uid.data_ptr(), iid.data_ptr(), dense_aug.data_ptr(),
                                        y.data_ptr(), w.data_ptr(), dg.data_ptr(),
                                        dense_part.data_ptr(), loss_part.data_ptr(), B, u_pad,
                                        i_pad, d_pad, blocks, uid.element_size(), s)
            raise_on(lib.lr_epoch_error_string, code, "lr_fullbatch_train_compact (epoch)")
            lr_fullbatch_train_compact.launches += 1
            _adam(lib, w, m, v, dg.data_ptr(), nbins, dense_part, d_pad, loss_part, losses, e, B,
                  hyper, s, "lr_fullbatch_train_compact")
            lr_fullbatch_train_compact.launches += 1
    return w, losses


lr_fullbatch_train.launches = 0
lr_fullbatch_train_compact.launches = 0
