"""Checked launchers of the serving top-k CUDA kernels (``csrc/serving_topk.cu``).

Each launcher checks device, dtype, contiguity, shapes and ``k``, allocates
its outputs with ``torch.empty``, launches on the current stream without
synchronising, and raises if the launch is refused. Each keeps a plain integer
count of its launches (``topk_serve_matmul.launches``), raised by one per
launch and nowhere else.

The library is built and loaded at the first launch, never at import, so this
module imports on machines without CUDA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deeplearningrecommendationsystem_tpu_torch.ops.cuda import build
from deeplearningrecommendationsystem_tpu_torch.ops.cuda.launch import (
    I as _I,
    P as _P,
    check as _check,
    raise_on,
    require_cuda,
    stream,
)

SOURCE = "serving_topk.cu"
MAX_K = 128  # kMaxK in the source
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper
_SEEN_DTYPES = (torch.bool, torch.int8, torch.uint8)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.serving_topk_matmul_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    lib.serving_topk_matmul_f32.restype = _I
    lib.serving_topk_scores_f32.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.serving_topk_scores_f32.restype = _I
    lib.serving_topk_error_string.argtypes = [_I]
    lib.serving_topk_error_string.restype = ctypes.c_char_p
    lib.serving_topk_matmul_smem_bytes.argtypes = [_I]
    lib.serving_topk_matmul_smem_bytes.restype = ctypes.c_size_t
    lib.serving_topk_max_k.argtypes = []
    lib.serving_topk_max_k.restype = _I
    if lib.serving_topk_max_k() != MAX_K:
        raise RuntimeError("serving_topk.cu and its launcher disagree on MAX_K")
    return lib


def _check_k(k: int, num_items: int) -> None:
    if not 1 <= k <= min(MAX_K, num_items):
        raise ValueError(f"k={k} must lie in [1, min({MAX_K}, num_items={num_items})]")


def _outputs(U: int, k: int, device: torch.device):
    return (
        torch.empty((U, k), dtype=torch.float32, device=device),
        torch.empty((U, k), dtype=torch.int32, device=device),
    )


def topk_serve_matmul(P: torch.Tensor, Q: torch.Tensor, seen: torch.Tensor, k: int):
    """Launch ``matmul_topk_kernel``: P [U, D] f32, Q [I, D] f32, seen [U, I]
    (bool/int8/uint8, nonzero = exclude) -> (values [U, k] f32, ids [U, k] int32)."""
    device = P.device
    require_cuda("topk_serve_matmul", device)
    _check("P", P, (torch.float32,), 2, device)
    _check("Q", Q, (torch.float32,), 2, device)
    _check("seen", seen, _SEEN_DTYPES, 2, device)
    (U, D), I = P.shape, Q.shape[0]
    if Q.shape[1] != D or tuple(seen.shape) != (U, I):
        raise ValueError(f"shapes P {tuple(P.shape)}, Q {tuple(Q.shape)}, seen {tuple(seen.shape)}")
    _check_k(k, I)
    lib = _lib()
    if lib.serving_topk_matmul_smem_bytes(D) > SMEM_LIMIT:
        raise ValueError(f"embedding dim D={D} needs more shared memory than a block has")
    out_v, out_i = _outputs(U, k, device)
    with torch.cuda.device(device):
        code = lib.serving_topk_matmul_f32(
            P.data_ptr(), Q.data_ptr(), seen.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            U, I, D, k, stream(device.index),
        )
    raise_on(lib.serving_topk_error_string, code, "topk_serve_matmul")
    topk_serve_matmul.launches += 1
    return out_v, out_i


def topk_scores(scores: torch.Tensor, seen: torch.Tensor, k: int):
    """Launch ``scores_topk_kernel``: scores [U, I] f32, seen [U, I] ->
    (values [U, k] f32, ids [U, k] int32)."""
    device = scores.device
    require_cuda("topk_scores", device)
    _check("scores", scores, (torch.float32,), 2, device)
    _check("seen", seen, _SEEN_DTYPES, 2, device)
    U, I = scores.shape
    if tuple(seen.shape) != (U, I):
        raise ValueError(f"shapes scores {tuple(scores.shape)}, seen {tuple(seen.shape)}")
    _check_k(k, I)
    lib = _lib()
    out_v, out_i = _outputs(U, k, device)
    with torch.cuda.device(device):
        code = lib.serving_topk_scores_f32(
            scores.data_ptr(), seen.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            U, I, k, stream(device.index),
        )
    raise_on(lib.serving_topk_error_string, code, "topk_scores")
    topk_scores.launches += 1
    return out_v, out_i


topk_serve_matmul.launches = 0
topk_scores.launches = 0
