"""Checked launcher of the fused MF training kernels (``csrc/mf_epoch.cu``).

``mf_fullbatch_train`` checks its inputs, allocates the master tables, the
Adam moments, the gradient sums and the loss history, then launches two
kernels per epoch on the current stream (the epoch's forward and backward,
then the Adam step), with no synchronisation between epochs. Its count
``mf_fullbatch_train.launches`` rises by one per kernel launch: two per epoch.

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

SOURCE = "mf_epoch.cu"
MAX_DIM = 128  # 32 lanes x kMaxColsPerLane in the source
ID_DTYPES = (torch.int32, torch.int64)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.mf_epoch_forward_backward.argtypes = [P, P, P, P, P, P, P, P, LL, I, I, I, I, I, P]
    lib.mf_epoch_forward_backward.restype = I
    lib.mf_epoch_adam.argtypes = [P, P, P, P, LL, P, P, P, P, LL] + [F] * 9 + [I, P]
    lib.mf_epoch_adam.restype = I
    lib.mf_epoch_error_string.argtypes = [I]
    lib.mf_epoch_error_string.restype = ctypes.c_char_p
    lib.mf_epoch_max_dim.argtypes = []
    lib.mf_epoch_max_dim.restype = I
    if lib.mf_epoch_max_dim() != MAX_DIM:
        raise RuntimeError("mf_epoch.cu and its launcher disagree on MAX_DIM")
    return lib


def mf_fullbatch_train(uid, iid, y, pu0, pi0, epochs: int, learning_rate: float,
                       weight_decay: float = 0.0, compute_dtype: str = "bfloat16",
                       b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Launch ``epochs`` x (``mf_epoch_kernel``, ``mf_adam_kernel``): uid, iid
    [B] int32/int64, y [B] f32, pu0 [U, D], pi0 [I, D] f32 -> (pu, pi, losses
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
    pu, pi = pu0.clone(), pi0.clone()
    mu, vu, du = (torch.zeros_like(pu) for _ in range(3))
    mi, vi, di = (torch.zeros_like(pi) for _ in range(3))
    losses = torch.zeros(epochs, dtype=torch.float32, device=device)
    hyper = (learning_rate, weight_decay, b1, 1.0 - b1, b2, 1.0 - b2, eps,
             math.log(b1), math.log(b2))
    bf16 = int(compute_dtype == "bfloat16")
    with torch.cuda.device(device):
        s = stream(device.index)
        for e in range(epochs):
            code = lib.mf_epoch_forward_backward(
                uid.data_ptr(), iid.data_ptr(), y.data_ptr(), pu.data_ptr(), pi.data_ptr(),
                du.data_ptr(), di.data_ptr(), losses[e:].data_ptr(), B, U, I_, D, bf16,
                uid.element_size(), s)
            raise_on(lib.mf_epoch_error_string, code, "mf_fullbatch_train (epoch)")
            mf_fullbatch_train.launches += 1
            code = lib.mf_epoch_adam(
                pu.data_ptr(), mu.data_ptr(), vu.data_ptr(), du.data_ptr(), U * D,
                pi.data_ptr(), mi.data_ptr(), vi.data_ptr(), di.data_ptr(), I_ * D,
                *hyper, e + 1, s)
            raise_on(lib.mf_epoch_error_string, code, "mf_fullbatch_train (adam)")
            mf_fullbatch_train.launches += 1
    return pu, pi, losses


mf_fullbatch_train.launches = 0
