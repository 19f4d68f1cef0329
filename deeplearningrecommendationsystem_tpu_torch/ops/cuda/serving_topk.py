"""Checked launchers of the serving top-k CUDA kernels (``csrc/serving_topk.cu``).

The launch convention is ``ops/cuda/gather.py``'s: each launcher checks
device, dtype, contiguity and shapes in one boolean test (``launch.check``
names the fault when it fails), allocates its outputs with ``torch.empty``
only, and calls the library's C entry with one packed block of 64-bit fields
that carries the device index (the C entry makes that device current itself)
and the current stream's raw handle. The library is opened as a
``ctypes.PyDLL``, as ``gather.py`` opens its own: the entry only enqueues work
and never waits, so releasing and retaking the GIL would cost more than the
call holds it. Each launcher raises if the launch is refused, and keeps a
plain integer count of its launches (``topk_serve_matmul.launches``), raised
by one per launch and nowhere else: one launch a call.

The launcher also picks how the kernel cuts the catalog (``matmul_plan``,
``scores_plan``): enough slices to fill the card's SMs at small user counts,
one slice where the users alone fill it. A split launch needs a workspace for
the slices' lists and the ticket counters that find each user's last slice.
It is kept per (device, stream) and grown when a call needs more. A new
workspace is zeroed on the caller's stream before it is published, so every
later launch on that stream finds its counters at 0, and each launch leaves
them at 0: the last block of a user tile resets its counter. Made once per
(device, stream, size), it saves a call the allocation and the zero fill of
its counters (see ``PERF.md``).

The library is built and loaded at the first launch, never at import, so this
module imports on machines without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
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

SOURCE = "serving_topk.cu"
MAX_K = 128  # kMaxK in the source
SMEM_LIMIT = 232_448 - 1_024  # kSmemLimit: a block's dynamic shared memory on Hopper
CHUNK = 128  # items a matmul block scores at a time (kChunk)
STEP = 256  # items a scores warp reads a step (kStep)
# The plans: a slice's list costs a sort and merge to make and to merge, so
# slices are added only until the card is full: the matmul kernel's blocks one
# wave (as many as fit the SMs at once), the scores kernel's warps
# SCORES_WARPS_PER_SM a SM; there are at most I / MIN_SLICE_ITEMS slices,
# rounded up.
SCORES_WARPS_PER_SM = 16
MIN_SLICE_ITEMS = 256 * 2
# a matmul block takes 64 users (else 8) from this many users and items on
WIDE_USERS, WIDE_ITEMS = 512, 16_384
_SEEN_DTYPES = (torch.bool, torch.int8, torch.uint8)
# csrc/serving_topk.cu's TopkArgs (a, q, seen, out_v, out_i, work, U, I, D, k,
# slices, slice_items, wide, work_tickets, device, stream)
_ARGS = struct.Struct("@16q")

# (serving_topk_matmul, serving_topk_scores, error_string, smem_bytes, resident):
# bound at the first launch
_entries = None
# (device index, stream handle) -> (workspace, its ticket slots, its list bytes)
_workspaces: dict = {}


def _bind():
    global _entries
    build.load(SOURCE)  # builds the library at its first use
    lib = ctypes.PyDLL(str(build.library_path(SOURCE)))
    for fn in (lib.serving_topk_matmul, lib.serving_topk_scores):
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = I
    lib.serving_topk_error_string.argtypes = [I]
    lib.serving_topk_error_string.restype = ctypes.c_char_p
    lib.serving_topk_matmul_smem_bytes.argtypes = [I, I]
    lib.serving_topk_matmul_smem_bytes.restype = ctypes.c_size_t
    lib.serving_topk_matmul_resident.argtypes = [I, I, I]
    lib.serving_topk_matmul_resident.restype = I
    lib.serving_topk_max_k.argtypes = []
    lib.serving_topk_max_k.restype = I
    if lib.serving_topk_max_k() != MAX_K:
        raise RuntimeError("serving_topk.cu and its launcher disagree on MAX_K")
    _entries = (lib.serving_topk_matmul, lib.serving_topk_scores, lib.serving_topk_error_string,
                lib.serving_topk_matmul_smem_bytes, lib.serving_topk_matmul_resident)
    return _entries


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _resident(D: int, wide: bool, index: int) -> int:
    """Matmul blocks of width D that fit one SM of device ``index`` at once."""
    n = (_entries or _bind())[4](D, int(wide), index)
    if n < 1:
        raise RuntimeError(f"topk_serve_matmul: no block of width D={D} fits an SM (error {-n})")
    return n


def _split(units: int, want: int, most: int):
    """(slices, units per slice): ``units`` cut into ``want`` equal runs, at
    least 1 and at most ``most``."""
    per = -(-units // max(1, min(want, most, units)))
    return -(-units // per), per


@functools.lru_cache(maxsize=1024)
def matmul_plan(U: int, I: int, D: int, index: int):
    """(wide, user tiles, slices, items per slice) of ``matmul_topk_kernel`` on
    device ``index``: 64-user tiles for large catalogs at many users, else 8;
    the catalog cut into slices of whole 128-item chunks, as many as fill one
    wave of blocks, at most I / MIN_SLICE_ITEMS of them, rounded up."""
    smem = (_entries or _bind())[3]
    wide = U >= WIDE_USERS and I >= WIDE_ITEMS and smem(D, 1) <= SMEM_LIMIT
    if not wide and smem(D, 0) > SMEM_LIMIT:
        raise ValueError(f"embedding dim D={D} needs more shared memory than a block has")
    tiles = -(-U // (64 if wide else 8))
    wave = _resident(D, wide, index) * _sms(index)
    slices, per = _split(-(-I // CHUNK), wave // tiles, -(-I // MIN_SLICE_ITEMS))
    return wide, tiles, slices, per * CHUNK


@functools.lru_cache(maxsize=1024)
def scores_plan(U: int, I: int, index: int):
    """(slices, items per slice) of ``scores_topk_kernel`` on device ``index``:
    one warp per (user, slice), about SCORES_WARPS_PER_SM warps a SM, in slices
    of whole 256-item steps, at most I / MIN_SLICE_ITEMS of them, rounded up."""
    slices, per = _split(-(-I // STEP), -(-SCORES_WARPS_PER_SM * _sms(index) // U),
                         -(-I // MIN_SLICE_ITEMS))
    return slices, per * STEP


def _workspace(index: int, handle: int, like: torch.Tensor, tickets: int, list_bytes: int):
    """(workspace, ticket slots) of the (device, stream), grown to hold
    ``tickets`` counters and ``list_bytes`` of lists. A new one is zeroed
    (``new_zeros``: a fill on the current stream, which is the stream
    ``handle``) before it goes into ``_workspaces``, so a launch from another
    thread that finds it there is enqueued after the fill. The caller holds
    the tensor until its launch is enqueued, so that another thread's growth
    cannot free it before then."""
    key = (index, handle)
    ws = _workspaces.get(key)
    if ws is not None and ws[1] >= tickets and ws[2] >= list_bytes:
        return ws[0], ws[1]
    if ws is not None:
        tickets, list_bytes = max(tickets, ws[1]), max(list_bytes, ws[2])
    buf = like.new_zeros(-(-tickets * 4 // 256) * 256 + list_bytes, dtype=torch.uint8)
    _workspaces[key] = (buf, tickets, list_bytes)
    return buf, tickets


def _checked_device(name: str, *tensors) -> int:
    """The CUDA device index of launcher ``name``'s (label, tensor, dtypes)
    arguments: all 2-D, on one device, of a listed dtype and contiguous. One
    boolean test; ``require_cuda`` and ``check`` name the fault when it fails."""
    index = tensors[0][1].get_device()
    if index < 0 or not all(t.get_device() == index and t.dtype in dtypes and t.dim() == 2
                            and t.is_contiguous() for _, t, dtypes in tensors):
        device = tensors[0][1].device
        require_cuda(name, device)
        for label, t, dtypes in tensors:
            check(label, t, dtypes, 2, device)
    return index


def _check_k(k: int, num_users: int, num_items: int) -> None:
    if num_users < 1:
        raise ValueError("top-k of no users")
    if not 1 <= k <= min(MAX_K, num_items):
        raise ValueError(f"k={k} must lie in [1, min({MAX_K}, num_items={num_items})]")


def _launch(which: int, name: str, index: int, a, q, seen, U: int, I: int, D: int, k: int,
            wide: int, tickets: int, slices: int, items: int):
    """Allocates the outputs, finds the workspace and calls C entry ``which``
    (0: matmul, 1: scores)."""
    entries = _entries or _bind()
    out_v = a.new_empty(U, k)
    out_i = a.new_empty(U, k, dtype=torch.int32)
    handle = stream(index)
    work, slots = (_workspace(index, handle, a, tickets, 8 * U * slices * k)
                   if slices > 1 else (None, 0))
    code = entries[which](_ARGS.pack(a.data_ptr(), q, seen.data_ptr(), out_v.data_ptr(),
                                     out_i.data_ptr(), 0 if work is None else work.data_ptr(),
                                     U, I, D, k, slices, items, wide, slots, index, handle))
    if code:
        raise_on(entries[2], code, name)
    return out_v, out_i


def topk_serve_matmul(P: torch.Tensor, Q: torch.Tensor, seen: torch.Tensor, k: int):
    """Launch ``matmul_topk_kernel``: P [U, D] f32, Q [I, D] f32, seen [U, I]
    (bool/int8/uint8, nonzero = exclude) -> (values [U, k] f32, ids [U, k] int32)."""
    index = _checked_device("topk_serve_matmul", ("P", P, (torch.float32,)),
                            ("Q", Q, (torch.float32,)), ("seen", seen, _SEEN_DTYPES))
    (U, D), I = P.shape, Q.shape[0]
    if Q.shape[1] != D or seen.shape[0] != U or seen.shape[1] != I:
        raise ValueError(f"shapes P {tuple(P.shape)}, Q {tuple(Q.shape)}, seen {tuple(seen.shape)}")
    _check_k(k, U, I)
    wide, tiles, slices, items = matmul_plan(U, I, D, index)
    out = _launch(0, "topk_serve_matmul", index, P, Q.data_ptr(), seen, U, I, D, k, wide, tiles,
                  slices, items)
    topk_serve_matmul.launches += 1
    return out


def topk_scores(scores: torch.Tensor, seen: torch.Tensor, k: int):
    """Launch ``scores_topk_kernel``: scores [U, I] f32, seen [U, I] ->
    (values [U, k] f32, ids [U, k] int32)."""
    index = _checked_device("topk_scores", ("scores", scores, (torch.float32,)),
                            ("seen", seen, _SEEN_DTYPES))
    U, I = scores.shape
    if tuple(seen.shape) != (U, I):
        raise ValueError(f"shapes scores {tuple(scores.shape)}, seen {tuple(seen.shape)}")
    _check_k(k, U, I)
    slices, items = scores_plan(U, I, index)
    out = _launch(1, "topk_scores", index, scores, 0, seen, U, I, 0, k, 0, U, slices, items)
    topk_scores.launches += 1
    return out


topk_serve_matmul.launches = 0
topk_scores.launches = 0
