"""Checked launchers of the embedding gather and its backward (``csrc/gather.cu``).

Each launcher checks device, dtype, contiguity and shapes, allocates its
output, launches on the current stream without synchronising, and raises if
the launch is refused. Each keeps a plain integer count of its launches
(``gather_rows.launches``), raised by one per launch and nowhere else. An
empty batch launches nothing.

The library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build
from deeplearningrecommendationsystem_tpu_torch.ops.cuda.launch import (
    LL,
    I,
    P,
    check,
    raise_on,
    require_cuda,
    stream,
)

SOURCE = "gather.cu"
TABLE_DTYPES = (torch.float32, torch.bfloat16)
ID_DTYPES = (torch.int32, torch.int64)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.gather_rows.argtypes = [P, P, P, LL, I, I, I, I, P]
    lib.gather_rows.restype = I
    lib.onehot_grad.argtypes = [P, P, P, LL, I, I, I, I, P]
    lib.onehot_grad.restype = I
    lib.gather_error_string.argtypes = [I]
    lib.gather_error_string.restype = ctypes.c_char_p
    return lib


def _vector_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy unit of 16, 8, 4 or 2 bytes that divides the row and
    every pointer."""
    for width in (16, 8, 4, 2):
        if row_bytes % width == 0 and all(t.data_ptr() % width == 0 for t in tensors):
            return width
    raise ValueError(f"rows of {row_bytes} bytes cannot be copied in 2-byte units")


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch ``gather_rows_kernel``: table [V, D] f32/bf16, ids [B] int32/int64
    -> [B, D] in the table's dtype."""
    device = table.device
    require_cuda("gather_rows", device)
    check("table", table, TABLE_DTYPES, 2, device)
    check("ids", ids, ID_DTYPES, 1, device)
    (V, D), B = table.shape, ids.shape[0]
    if V < 1 or D < 1:
        raise ValueError(f"table shape {tuple(table.shape)} is empty")
    out = torch.empty((B, D), dtype=table.dtype, device=device)
    if B == 0:
        return out
    row_bytes = D * table.element_size()
    width = _vector_bytes(row_bytes, table, out)
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.gather_rows(table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, V, row_bytes,
                               width, ids.element_size(), stream(device))
    raise_on(lib.gather_error_string, code, "gather_rows")
    gather_rows.launches += 1
    return out


def onehot_grad(ids: torch.Tensor, g: torch.Tensor, vocab: int) -> torch.Tensor:
    """Launch ``onehot_grad_kernel``: ids [N] int32/int64, g [N, D] f32/bf16
    -> [vocab, D] float32 sums of the rows of g per id."""
    device = g.device
    require_cuda("onehot_grad", device)
    check("ids", ids, ID_DTYPES, 1, device)
    check("g", g, TABLE_DTYPES, 2, device)
    N, D = g.shape
    if ids.shape[0] != N:
        raise ValueError(f"ids {tuple(ids.shape)} and g {tuple(g.shape)} differ in rows")
    if vocab < 1 or D < 1:
        raise ValueError(f"vocab={vocab} and D={D} must be positive")
    out = torch.zeros((vocab, D), dtype=torch.float32, device=device)
    if N == 0:
        return out
    lib = _lib()
    with torch.cuda.device(device):
        code = lib.onehot_grad(ids.data_ptr(), g.data_ptr(), out.data_ptr(), N, vocab, D,
                               int(g.dtype == torch.bfloat16), ids.element_size(), stream(device))
    raise_on(lib.gather_error_string, code, "onehot_grad")
    onehot_grad.launches += 1
    return out


gather_rows.launches = 0
onehot_grad.launches = 0
