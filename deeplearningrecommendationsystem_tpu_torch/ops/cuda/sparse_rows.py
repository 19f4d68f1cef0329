"""Checked launchers of the row-sparse update's kernels (``csrc/sparse_rows.cu``):
``train/sparse.py``'s dedup and row-wise AdaGrad on CUDA float32 rows.

As in ``ops/cuda/gather.py``: each launcher checks its tensors in one boolean
test (``launch.check`` names the fault when it fails), allocates with
``torch.empty`` only, passes its arguments to the library's C entry as one
packed block of 64-bit fields with the device index and the current stream's
raw handle, and raises if the launch is refused. Each keeps a plain integer
count of its kernel launches (``dedup_rows.launches``), raised there and
nowhere else; an empty batch launches nothing. The library is built and loaded
at the first launch, never at import.

``dedup_rows`` first groups the ids on the stream: one stable sort of the ids
as int32 keys (the sentinel ``vocab`` must fit one) and a cumulative sum of
the key changes, every shape ``[B]``, so nothing waits for the card. Its C
entry then launches, on the current stream, the long runs' kernel and the
short runs' (two launches a call), or for rows of one column one kernel that
sums each run in the order of ``index_put_``'s stride-1 kernel (one launch a
call).
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

SOURCE = "sparse_rows.cu"
ID_DTYPES = (torch.int32, torch.int64)
ROW_DTYPES = (torch.float32,)
# the keys and slots are int32: ids in [0, vocab], vocab + 1 < 2**31
MAX_VOCAB = 2**31 - 2
# csrc/sparse_rows.cu's DedupArgs (keys, order, runs, g, uids, out, B, D, vocab,
# uid_bytes, device, stream) and AdagradArgs (table, accum, uids, g, B, D, vocab,
# uid_bytes, lr, eps, device, stream): pointers and integers as native 64-bit
# fields, lr and eps as doubles
_DEDUP_ARGS = struct.Struct("@12q")
_ADAGRAD_ARGS = struct.Struct("@8q2d2q")

# (dedup_segments, rowwise_adagrad, sparse_rows_error_string): bound at the first launch
_entries = None


def _bind():
    global _entries
    build.load(SOURCE)  # builds the library at its first use
    lib = ctypes.PyDLL(str(build.library_path(SOURCE)))
    for fn in (lib.dedup_segments, lib.rowwise_adagrad):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = I
    lib.sparse_rows_error_string.argtypes = [I]
    lib.sparse_rows_error_string.restype = ctypes.c_char_p
    _entries = (lib.dedup_segments, lib.rowwise_adagrad, lib.sparse_rows_error_string)
    return _entries


def _checked_device(name: str, *args) -> int:
    """The CUDA device index of launcher ``name``'s (label, tensor, dtypes, ndim)
    arguments, all on one device, of a listed dtype and ndim dims, and
    contiguous. One boolean test; ``require_cuda`` and ``check`` name the
    fault when it fails."""
    first = args[0][1]
    index = first.get_device()
    if index < 0 or not all(t.get_device() == index and t.dtype in dtypes and t.dim() == ndim
                            and t.is_contiguous() for _, t, dtypes, ndim in args):
        require_cuda(name, first.device)
        for label, t, dtypes, ndim in args:
            check(label, t, dtypes, ndim, first.device)
    return index


def _check_sizes(name: str, B: int, D: int, vocab: int) -> None:
    if not (0 < vocab <= MAX_VOCAB and D > 0 and B < 2**31):
        raise ValueError(f"{name}: vocab={vocab}, D={D}, B={B}: need 0 < vocab <= {MAX_VOCAB}, "
                         "D > 0 and B < 2**31")


def dedup_rows(ids: torch.Tensor, row_grads: torch.Tensor, vocab: int):
    """``train/sparse.py::dedup_rows`` on the card: ids [B] int32/int64 in
    [0, vocab], row_grads [B, D] float32 -> (uids [B] in the ids' dtype, the
    distinct ids ascending then ``vocab``; ugrads [B, D] float32, each distinct
    id's rows summed in their order in the batch, zero rows after)."""
    index = _checked_device("dedup_rows", ("ids", ids, ID_DTYPES, 1),
                            ("row_grads", row_grads, ROW_DTYPES, 2))
    B, D = row_grads.shape
    if ids.shape[0] != B:
        raise ValueError(f"ids {tuple(ids.shape)} and row_grads {tuple(row_grads.shape)} differ "
                         "in rows")
    _check_sizes("dedup_rows", B, D, vocab)
    uids, ugrads = ids.new_empty(B), row_grads.new_empty(B, D)
    if B == 0:
        return uids, ugrads
    keys, order = torch.sort(ids.to(torch.int32), stable=True)
    runs = torch.cumsum(keys[1:] != keys[:-1], 0, dtype=torch.int32)
    entry, _, error_string = _entries or _bind()
    code = entry(_DEDUP_ARGS.pack(keys.data_ptr(), order.data_ptr(), runs.data_ptr(),
                                  row_grads.data_ptr(), uids.data_ptr(), ugrads.data_ptr(), B, D,
                                  vocab, uids.element_size(), index, stream(index)))
    if code:
        raise_on(error_string, code, "dedup_rows")
    dedup_rows.launches += 1 if D == 1 else 2
    return uids, ugrads


def rowwise_adagrad(table: torch.Tensor, accum: torch.Tensor, uids: torch.Tensor,
                    ugrads: torch.Tensor, lr: float, eps: float) -> None:
    """``train/sparse.py::rowwise_adagrad`` on the card, in place: table
    [vocab, D] float32 and accum [vocab] float32 advance on the rows of the
    slots of uids [B] int32/int64 that are below ``vocab``, with ugrads [B, D]
    float32 their gradients."""
    index = _checked_device("rowwise_adagrad", ("table", table, ROW_DTYPES, 2),
                            ("accum", accum, ROW_DTYPES, 1), ("uids", uids, ID_DTYPES, 1),
                            ("ugrads", ugrads, ROW_DTYPES, 2))
    (V, D), B = table.shape, uids.shape[0]
    if accum.shape[0] != V or ugrads.shape != (B, D):
        raise ValueError(f"table {tuple(table.shape)}, accum {tuple(accum.shape)}, uids "
                         f"{tuple(uids.shape)} and ugrads {tuple(ugrads.shape)} disagree")
    _check_sizes("rowwise_adagrad", B, D, V)
    if B == 0:
        return
    _, entry, error_string = _entries or _bind()
    code = entry(_ADAGRAD_ARGS.pack(table.data_ptr(), accum.data_ptr(), uids.data_ptr(),
                                    ugrads.data_ptr(), B, D, V, uids.element_size(), lr, eps,
                                    index, stream(index)))
    if code:
        raise_on(error_string, code, "rowwise_adagrad")
    rowwise_adagrad.launches += 1


dedup_rows.launches = 0
rowwise_adagrad.launches = 0
