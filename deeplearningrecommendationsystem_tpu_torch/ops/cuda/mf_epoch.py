"""Checked launcher of the fused MF trainer (``csrc/mf_epoch.cu``).

``mf_fullbatch_train`` checks its inputs, builds the rows' user and item
orders with their segment offsets (``ops/segments.py::id_segments``, once a
call: the ids do not change across epochs), allocates the output tables, the
loss history and one workspace, and makes one cooperative launch of
``mf_train_kernel`` on the current stream for the whole run. Its count
``mf_fullbatch_train.launches`` rises by one per kernel launch: one a call.

The grid is every block the card keeps resident at once; a grid that cannot
be resident makes the launch fail and the launcher raise.

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

SOURCE = "mf_epoch.cu"
MAX_DIM = 512  # 32 lanes x kMaxColsPerLane in the source
ID_DTYPES = (torch.int32, torch.int64)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.mf_train.argtypes = [P] * 13 + [LL, I, I, I, I] + [F] * 9 + [I, I, I, P]
    lib.mf_train.restype = I
    lib.mf_train_grid.argtypes = [I, I]
    lib.mf_train_grid.restype = I
    lib.mf_train_workspace_bytes.argtypes = [LL, I, I, I, I]
    lib.mf_train_workspace_bytes.restype = ctypes.c_size_t
    lib.mf_epoch_error_string.argtypes = [I]
    lib.mf_epoch_error_string.restype = ctypes.c_char_p
    lib.mf_epoch_max_dim.argtypes = []
    lib.mf_epoch_max_dim.restype = I
    if lib.mf_epoch_max_dim() != MAX_DIM:
        raise RuntimeError("mf_epoch.cu and its launcher disagree on MAX_DIM")
    return lib


@functools.cache
def _grid(index: int, D: int, bf16: int) -> int:
    """Blocks of one launch on device ``index``: all it keeps resident."""
    with torch.cuda.device(index):
        blocks = _lib().mf_train_grid(D, bf16)
    if blocks < 1:
        raise RuntimeError(f"mf_fullbatch_train: no resident grid for D={D}")
    return blocks


def mf_fullbatch_train(uid, iid, y, pu0, pi0, epochs: int, learning_rate: float,
                       weight_decay: float = 0.0, compute_dtype: str = "bfloat16",
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Launch ``mf_train_kernel`` once for ``epochs`` epochs: uid, iid [B]
    int32/int64, y [B] f32, pu0 [U, D], pi0 [I, D] f32 -> (pu, pi, losses
    [epochs]), all f32 on the device."""
    device = pu0.device
    require_cuda("mf_fullbatch_train", device)
    check("uid", uid, ID_DTYPES, 1, device)
    check("iid", iid, (uid.dtype,), 1, device)
    check("y", y, (torch.float32,), 1, device)
    check("pu0", pu0, (torch.float32,), 2, device)
    check("pi0", pi0, (torch.float32,), 2, device)
    (U, D), (I_, D_i), B = pu0.shape, pi0.shape, uid.shape[0]
    if D_i != D or iid.shape[0] != B or y.shape[0] != B:
        raise ValueError(f"shapes uid {tuple(uid.shape)}, iid {tuple(iid.shape)}, "
                         f"y {tuple(y.shape)}, pu0 {tuple(pu0.shape)}, pi0 {tuple(pi0.shape)}")
    if not (1 <= D <= MAX_DIM) or B < 1 or U < 1 or I_ < 1 or epochs < 0:
        raise ValueError(f"need 1 <= D={D} <= {MAX_DIM}, B={B} >= 1, U, I >= 1, epochs >= 0")
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute_dtype!r}: 'float32' or 'bfloat16'")
    lib = _lib()
    bf16 = int(compute_dtype == "bfloat16")
    with torch.cuda.device(device):
        order_u, off_u = id_segments(uid, U)
        order_i, off_i = id_segments(iid, I_)
        blocks = _grid(device.index, D, bf16)
        work = torch.empty(lib.mf_train_workspace_bytes(B, U, I_, D, blocks), dtype=torch.uint8,
                           device=device)
        pu, pi = torch.empty_like(pu0), torch.empty_like(pi0)
        losses = torch.empty(epochs, dtype=torch.float32, device=device)
        code = lib.mf_train(
            uid.data_ptr(), iid.data_ptr(), y.data_ptr(), pu0.data_ptr(), pi0.data_ptr(),
            order_u.data_ptr(), off_u.data_ptr(), order_i.data_ptr(), off_i.data_ptr(),
            pu.data_ptr(), pi.data_ptr(), losses.data_ptr(), work.data_ptr(), B, U, I_, D, epochs,
            learning_rate, weight_decay, b1, 1.0 - b1, b2, 1.0 - b2, eps, math.log(b1),
            math.log(b2), bf16, uid.element_size(), blocks, stream(device.index))
        raise_on(lib.mf_epoch_error_string, code, "mf_fullbatch_train")
        mf_fullbatch_train.launches += 1
    return pu, pi, losses


mf_fullbatch_train.launches = 0
