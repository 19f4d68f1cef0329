"""Checked launchers of the embedding gather and its backward (``csrc/gather.cu``).

Each launcher checks device, dtype, contiguity and shapes in one boolean
test (``launch.check`` names the fault when it fails), allocates its
output with ``torch.empty`` only (``Tensor.new_empty``), and calls the library's C
entry with the device index and the current stream's raw handle. The C entry
makes the device current itself, picks the copy width and, for the backward,
zeroes the output on the stream, then launches without synchronising; the
launcher raises if the launch is refused. Each keeps a plain integer count of
its launches (``gather_rows.launches``), raised by one per launch and nowhere
else. An empty batch launches nothing (the backward's zeros are a memset).

These calls sit on the host's critical path at small batches (a bias table's
77 ids, a 512-id target tile), where a launch is mostly host time. So the C
functions are bound once; their arguments travel as one packed block of
64-bit fields (ctypes converts one argument instead of nine or ten); and the
library is opened as a ``ctypes.PyDLL``, which keeps the GIL across the call:
the C entry only enqueues work and never waits, so releasing and taking back
the GIL would cost more than the call holds it.

The library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import struct

import torch

from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build
from deeplearningrecommendationsystem_tpu_torch.ops.cuda.launch import (
    I,
    check,
    raise_on,
    require_cuda,
    stream,
)

SOURCE = "gather.cu"
TABLE_DTYPES = (torch.float32, torch.bfloat16)
ID_DTYPES = (torch.int32, torch.int64)
# csrc/gather.cu's GatherArgs (table, ids, out, B, V, row_bytes, id_bytes,
# device, stream) and GradArgs (ids, g, out, N, V, D, g_bf16, id_bytes, device,
# stream): pointers and integers alike as native 64-bit fields
_GATHER_ARGS = struct.Struct("@9q")
_GRAD_ARGS = struct.Struct("@10q")

# (gather_rows, onehot_grad, gather_error_string): the C functions, bound at the first launch
_entries = None


def _bind():
    global _entries
    build.load(SOURCE)  # builds the library at its first use
    lib = ctypes.PyDLL(str(build.library_path(SOURCE)))
    for fn in (lib.gather_rows, lib.onehot_grad):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = I
    lib.gather_error_string.argtypes = [I]
    lib.gather_error_string.restype = ctypes.c_char_p
    _entries = (lib.gather_rows, lib.onehot_grad, lib.gather_error_string)
    return _entries


def _checked_device(name: str, first, second) -> int:
    """The CUDA device index of launcher ``name``'s two (label, tensor, dtypes,
    ndim) arguments, both on one device, of a listed dtype and ndim dims, and
    contiguous. One boolean test (``Tensor.get_device`` builds no
    ``torch.device``); ``require_cuda`` and ``check`` name the fault when it fails."""
    a, b = first[1], second[1]
    index = a.get_device()
    if (index < 0 or b.get_device() != index or a.dtype not in first[2]
            or b.dtype not in second[2] or a.dim() != first[3] or b.dim() != second[3]
            or not a.is_contiguous() or not b.is_contiguous()):
        require_cuda(name, a.device)
        for label, t, dtypes, ndim in (first, second):
            check(label, t, dtypes, ndim, a.device)
    return index


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Launch ``gather_rows_kernel``: table [V, D] f32/bf16, ids [B] int32/int64
    -> [B, D] in the table's dtype."""
    index = _checked_device("gather_rows", ("table", table, TABLE_DTYPES, 2),
                            ("ids", ids, ID_DTYPES, 1))
    (V, D), B = table.shape, ids.shape[0]
    if V < 1 or D < 1:
        raise ValueError(f"table shape {tuple(table.shape)} is empty")
    out = table.new_empty(B, D)
    if B == 0:
        return out
    entry, _, error_string = _entries or _bind()
    code = entry(_GATHER_ARGS.pack(table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, V,
                                   D * table.element_size(), ids.element_size(), index,
                                   stream(index)))
    if code:
        raise_on(error_string, code, "gather_rows")
    gather_rows.launches += 1
    return out


def onehot_grad(ids: torch.Tensor, g: torch.Tensor, vocab: int) -> torch.Tensor:
    """Launch ``onehot_grad_kernel``: ids [N] int32/int64, g [N, D] f32/bf16
    -> [vocab, D] float32 sums of the rows of g per id."""
    index = _checked_device("onehot_grad", ("ids", ids, ID_DTYPES, 1),
                            ("g", g, TABLE_DTYPES, 2))
    N, D = g.shape
    if ids.shape[0] != N:
        raise ValueError(f"ids {tuple(ids.shape)} and g {tuple(g.shape)} differ in rows")
    if vocab < 1 or D < 1:
        raise ValueError(f"vocab={vocab} and D={D} must be positive")
    out = g.new_empty(vocab, D, dtype=torch.float32)
    _, entry, error_string = _entries or _bind()
    code = entry(_GRAD_ARGS.pack(ids.data_ptr(), g.data_ptr(), out.data_ptr(), N, vocab, D,
                                 g.dtype == torch.bfloat16, ids.element_size(), index,
                                 stream(index)))
    if code:
        raise_on(error_string, code, "onehot_grad")
    if N:
        onehot_grad.launches += 1
    return out


gather_rows.launches = 0
onehot_grad.launches = 0
