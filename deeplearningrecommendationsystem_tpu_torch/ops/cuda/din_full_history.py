"""Checked launcher of DIN's full-history catalog scorer
(``csrc/din_full_history.cu``) and of the fc head it hands its pooled rows to
(``csrc/din_head.cu``'s ``din_head_fwd_fc``).

``din_full_history_scores(offsets, order, ids, item, att, fc, users)``: the
histories packed as CSR (int32 ``offsets`` [U + 1] into ``ids`` [N], every
history at least one position long, every id below I:
``ops/din_full_history.py`` checks them on the host) with ``order`` [U]: the
users in chunks of ``users`` (``users_per_launch``), each chunk's users
longest history first, numbered from the chunk's first; the item table [I, D]
and DIN's two MLPs (attention 3D -> A1 -> A2 -> 1 with biases on its hidden
layers, fc 2D -> F1 -> F2 -> 1), all float32 on one card. It makes the
activation unit's first layer once per item with two plain products,
HW = item wh and TW = item wt + b1 ([I, A1] each), then for each chunk of
users launches ``din_full_history_kernel`` (pooled rows [users * I, D]) and
``din_head_fc_kernel`` over [pooled, target] (3xTF32, the float32 DIN head's
fc head), and returns the logits [U, I]. The chunks hold a launch's pooled
and target rows within ``ROW_BUDGET`` bytes, so the memory a call takes does
not grow with the catalog; at ml-100k (943 users, 1,682 items, D 64) that is
two chunks. Its count of launches (``.launches``) rises by one for each
launch, two a chunk, and nowhere else. It raises on anything the kernels do
not take (``widths``): widths not multiples of 4, D past ``MAX_DIM``, tiles
that do not fit (``fits``; the fc head: ``din_head.fits``' ``TF32_FWD``),
another dtype, device or shape, non-contiguous or unaligned float tensors.

The libraries are built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as _dh
from deeplearningrecommendationsystem_tpu_torch.ops.cuda.launch import (
    I,
    P,
    check,
    raise_on,
    require_cuda,
    stream,
)
from deeplearningrecommendationsystem_tpu_torch.ops.din_head import din_head_weights

SOURCE = "din_full_history.cu"
ITEM_TILE = 16  # kItems: the items of a warp's unit, one m16 tile's rows
POSITION_STEP = 2  # kStep: the history positions a step scores, an m16 tile each
MAX_DIM = 64  # kMaxD: a lane keeps D / 4 pooled columns of two items in registers
WARPS = 8  # kWarps: warps of a block, each with its own TW tile in shared memory
ROW_BUDGET = 1 << 29  # bytes of one launch's pooled and target rows together
_F32 = (torch.float32,)
_I32 = (torch.int32,)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.din_full_history_pool.argtypes = [P] * 10 + [I] * 5 + [P]
    lib.din_full_history_pool.restype = I
    lib.din_full_history_fits.argtypes = [I, I, I]
    lib.din_full_history_fits.restype = I
    lib.din_full_history_error_string.argtypes = [I]
    lib.din_full_history_error_string.restype = ctypes.c_char_p
    for name, want in (("item_tile", ITEM_TILE), ("position_step", POSITION_STEP),
                       ("max_dim", MAX_DIM), ("warps", WARPS)):
        fn = getattr(lib, f"din_full_history_{name}")
        fn.argtypes, fn.restype = [], I
        if fn() != want:
            raise RuntimeError(f"din_full_history.cu and its launcher disagree on {name}")
    return lib


def fits(D: int, A1: int, A2: int) -> bool:
    """``din_full_history_fits`` of the library, from the widths alone: D, A1,
    A2 multiples of 4, D at most MAX_DIM, and the split w2 (A2 rounded up to
    64 rows of A1 rounded up to 8 columns, hi and lo), b2, w3 and each warp's
    TW tile (16 rows, A1 rounded up to 8 and strided 8 mod 32) within
    the ``SMEM_LIMIT`` bytes of ``ops/cuda/din_head.py``."""
    if any(n < 4 or n % 4 for n in (D, A1, A2)) or D > MAX_DIM:
        return False
    A1p, A2p = _dh._up(A1, 8), _dh._up(A2, 64)
    regions = (4 * A2p * _dh._up(A1p // 2, 8), A2p, A2p, WARPS * ITEM_TILE * _dh._stride8(A1p))
    return 4 * sum(_dh._up(n, 4) for n in regions) <= _dh.SMEM_LIMIT


def users_per_launch(U: int, I: int, D: int) -> int:
    """The users one launch of the kernel and the fc head scores: U split into
    the fewest chunks, as even as can be, whose pooled and target rows
    (2 * users * I * D float32) fit in ``ROW_BUDGET`` bytes; one at least."""
    most = max(1, ROW_BUDGET // (2 * 4 * I * D))
    return -(-U // -(-U // most))


def widths(item, att, fc):
    """(D, A1, A2, F1, F2) of the item table [I, D] and the two MLPs, after the
    checks of their dtypes, devices and shapes; raises TypeError or ValueError
    on anything the kernels do not take. ``ops/din_full_history.py::
    full_history_route`` is this check, decided before any launch."""
    device = item.device
    check("item", item, _F32, 2, device)
    D = item.shape[1]
    if len(att) != 3 or any("b" not in layer for layer in att[:2]) or len(fc) != 3:
        raise ValueError("din_full_history_scores takes attention and fc MLPs of three layers, "
                         "biases on the attention net's hidden layers")
    A1, A2 = att[0]["w"].shape[-1], att[1]["w"].shape[-1]
    F1, F2 = fc[0]["w"].shape[-1], fc[1]["w"].shape[-1]
    want = {"att.0.w": (att[0]["w"], (3 * D, A1)), "att.1.w": (att[1]["w"], (A1, A2)),
            "att.2.w": (att[2]["w"], (A2, 1)),
            "fc.0.w": (fc[0]["w"], (2 * D, F1)), "fc.1.w": (fc[1]["w"], (F1, F2)),
            "fc.2.w": (fc[2]["w"], (F2, 1))}
    for net, layers in (("att", att), ("fc", fc)):
        for k, layer in enumerate(layers):
            if "b" in layer:
                want[f"{net}.{k}.b"] = (layer["b"], (layer["w"].shape[-1],))
    for name, (t, shape) in want.items():
        check(name, t, _F32, len(shape), device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not fits(D, A1, A2):
        raise ValueError(f"din_full_history_scores takes no tile at D={D}, A=({A1}, {A2}): widths "
                         f"multiples of 4, D at most {MAX_DIM}, the tiles within shared memory")
    if max(F1, F2) > _dh.MAX_FC or not _dh.fits(1, D, A1, A2, F1, F2) & _dh.TF32_FWD:
        raise ValueError(f"the fc head's kernel takes no tile at D={D}, F=({F1}, {F2})")
    return D, A1, A2, F1, F2


def din_full_history_scores(offsets, order, ids, item, att, fc, users):
    """Logits [U, I] of every item against each user's complete history: see
    the module's docstring. The inputs carry no autograd graph into the
    kernels, and the logits none out of them."""
    device = item.device
    require_cuda("din_full_history_scores", device)
    D, A1, A2, F1, F2 = widths(item, att, fc)
    for name, t in (("offsets", offsets), ("order", order), ("ids", ids)):
        check(name, t, _I32, 1, device)
    U, num_items = order.shape[0], item.shape[0]
    if U < 1 or offsets.shape[0] != U + 1 or ids.shape[0] < U:
        raise ValueError(f"offsets [{offsets.shape[0]}], order [{U}], ids [{ids.shape[0]}]: need "
                         "U >= 1 users, U + 1 offsets and a position for every user")
    if users < 1:
        raise ValueError(f"din_full_history_scores takes chunks of at least one user, got {users}")
    users = min(users, U)
    with torch.no_grad():
        w1 = att[0]["w"]
        hw = (item @ (w1[:D] + w1[D:2 * D])).contiguous()
        tw = (item @ (w1[2 * D:] - w1[D:2 * D]) + att[0]["b"]).contiguous()
        weights = tuple(w.contiguous() for w in din_head_weights(att, fc, D))
        rows = (hw, tw, item, att[1]["w"], att[1]["b"], att[2]["w"])
        if any(t.data_ptr() % 16 for t in rows + weights):
            raise ValueError("din_full_history_scores: every float tensor must start on a 16-byte "
                             "boundary")
        lib, head, pointers = _lib(), _dh._lib(), _dh._pointers(weights)
        pooled = torch.empty((users * num_items, D), dtype=torch.float32, device=device)
        target = item.repeat(users, 1)  # the fc head's target rows, user-major
        logits = torch.empty((U * num_items,), dtype=torch.float32, device=device)
        with torch.cuda.device(device):
            s = stream(device.index)
            for u0 in range(0, U, users):
                n = min(users, U - u0)
                args = (offsets[u0:], order[u0:], ids) + rows
                code = lib.din_full_history_pool(*(t.data_ptr() for t in args), pooled.data_ptr(),
                                                 n, num_items, D, A1, A2, s)
                raise_on(lib.din_full_history_error_string, code, "din_full_history_scores (pool)")
                din_full_history_scores.launches += 1
                code = head.din_head_fwd_fc(pooled.data_ptr(), target.data_ptr(), pointers,
                                            logits[u0 * num_items:].data_ptr(), n * num_items, 1,
                                            D, A1, A2, F1, F2, s)
                raise_on(head.din_head_error_string, code, "din_full_history_scores (fc head)")
                din_full_history_scores.launches += 1
    return logits.view(U, num_items)


din_full_history_scores.launches = 0
