"""Checked launchers of the fused DIN head kernels (``csrc/din_head.cu``).

``din_head_fused``, the forward: in bfloat16 one launch of ``din_fwd_kernel``
(its products on the tensor cores, m16n8k16); in float32 two launches on the
tensor cores in float32 accuracy (3xTF32), the attention stage
(``din_pool_kernel`` with b3, into a pooled [B, D] buffer) and the fc head
(``din_head_fc_kernel``), or, at widths whose tiles do not fit those two
kernels (``din_head_fwd_tf32``), one launch of ``din_fwd_kernel`` on CUDA
cores. ``din_head_fused_bwd`` launches the backward kernel, which writes d
hist, d target, one slot of weight-gradient sums per block and the fc head's
rows; the kernel that turns those rows into the fc head's two large weight
gradients, per block; and the kernel that sums the slots in block order:
three launches (float32 FMA on CUDA cores in float32; bf16 products on the
tensor cores but the recompute of the forward). Each keeps
a count of its launches (``.launches``), raised by one per kernel launch and
nowhere else, and the same count by the inputs' dtype
(``.launches_by_dtype``). Both take float32 or bfloat16, one dtype for
hist_e, target_e and the 14 weights (the JAX kernel's single compute dtype; a
mix raises), on the device of ``hist_e``; the widths must be multiples of 4,
the fc widths at most 2048 and L at most 64. The forward returns logits in the
inputs' dtype; the backward takes a cotangent g of either dtype (widened to
float32 for the kernel) and returns float32 gradients.

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

SOURCE = "din_head.cu"
MAX_HISTORY = 64  # kMaxHistory in csrc/din_common.cuh
MAX_FC = 2048  # the fc widths din_head_bwd_fc_kernel takes: 4 columns a thread
DTYPES = (torch.float32, torch.bfloat16)
_GRADS = 13  # the slot's blocks: u1p and u1t share one, u1 [2D, F1]


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load(SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``din_head.cu``) with its entry points' argument and
    result types set, checked against this launcher."""
    W = ctypes.POINTER(P)
    lib.din_head_fwd.argtypes = [P, P, W, P, LL, I, I, I, I, I, I, I, P]
    lib.din_head_fwd.restype = I
    lib.din_head_bwd_blocks.argtypes = [LL, I, I, I, I, I, I, I]
    lib.din_head_bwd_blocks.restype = I
    lib.din_head_bwd.argtypes = [P, P, W, P, P, P, P, P, LL, I, I, I, I, I, I, I, I, P]
    lib.din_head_bwd.restype = I
    lib.din_head_bwd_fc.argtypes = [P, P, LL, I, I, I, I, I, I, I, P]
    lib.din_head_bwd_fc.restype = I
    lib.din_head_bwd_reduce.argtypes = [P, P, I, I, P]
    lib.din_head_bwd_reduce.restype = I
    lib.din_head_fwd_tf32.argtypes = [I, I, I, I, I, I]
    lib.din_head_fwd_tf32.restype = I
    lib.din_head_fwd_pool.argtypes = [P, P, W, P, LL, I, I, I, I, I, I, P]
    lib.din_head_fwd_pool.restype = I
    lib.din_head_fwd_fc.argtypes = [P, P, W, P, LL, I, I, I, I, I, I, P]
    lib.din_head_fwd_fc.restype = I
    lib.din_head_grad_offsets.argtypes = [I, I, I, I, I, ctypes.POINTER(I)]
    lib.din_head_grad_offsets.restype = I
    lib.din_head_error_string.argtypes = [I]
    lib.din_head_error_string.restype = ctypes.c_char_p
    lib.din_head_max_history.argtypes = []
    lib.din_head_max_history.restype = I
    if lib.din_head_max_history() != MAX_HISTORY:
        raise RuntimeError("din_head.cu and its launcher disagree on the longest history")
    return lib


def _check(hist_e, target_e, weights, name: str):
    """(B, L, D, A1, A2, F1, F2) after the device, dtype, shape, contiguity and
    alignment checks."""
    device = hist_e.device
    require_cuda(name, device)
    if len(weights) != 14:
        raise ValueError(f"{name} takes the 14 weights of din_head_weights, got {len(weights)}")
    check("hist_e", hist_e, DTYPES, 3, device)
    dtype = hist_e.dtype
    check("target_e", target_e, (dtype,), 2, device)
    B, L, D = hist_e.shape
    A1, A2 = weights[0].shape[1], weights[3].shape[1]
    F1, F2 = weights[7].shape[1], weights[10].shape[1]
    want = [(D, A1), (D, A1), (1, A1), (A1, A2), (1, A2), (A2, 1), (1, 1),
            (D, F1), (D, F1), (1, F1), (F1, F2), (1, F2), (F2, 1), (1, 1)]
    for i, (w, shape) in enumerate(zip(weights, want)):
        check(f"weight {i}", w, (dtype,), 2, device)
        if tuple(w.shape) != shape:
            raise ValueError(f"weight {i} has shape {tuple(w.shape)}, expected {shape}")
    if tuple(target_e.shape) != (B, D):
        raise ValueError(f"target_e {tuple(target_e.shape)} is not [B, D] = [{B}, {D}]")
    if B < 1 or not 1 <= L <= MAX_HISTORY:
        raise ValueError(f"need B={B} >= 1 and 1 <= L={L} <= {MAX_HISTORY}")
    if any(n < 4 or n % 4 for n in (D, A1, A2, F1, F2)) or max(F1, F2) > MAX_FC:
        raise ValueError(f"widths D={D}, A=({A1}, {A2}), F=({F1}, {F2}) must be multiples of 4"
                         f", F at most {MAX_FC}")
    if any(t.data_ptr() % 16 for t in (hist_e, target_e, *weights)):
        raise ValueError(f"{name}: every tensor must start on a 16-byte boundary")
    return B, L, D, A1, A2, F1, F2


def _is_bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def _pointers(weights):
    return (P * 14)(*(w.data_ptr() for w in weights))


def _counted(fn, dtype) -> None:
    """One more launch of ``fn``'s kernels, of inputs in ``dtype``."""
    fn.launches += 1
    fn.launches_by_dtype[str(dtype).split(".")[1]] += 1


def din_head_fused(hist_e, target_e, weights):
    """Launch the forward: hist_e [B, L, D], target_e [B, D] and the 14
    weights, all f32 or all bf16 -> logits [B] in that dtype. bf16:
    ``din_fwd_kernel<bf16>``; f32: ``din_pool_kernel`` (b3 kept) and
    ``din_head_fc_kernel`` on the tensor cores, or ``din_fwd_kernel<float>`` on
    CUDA cores where the widths do not fit the pair."""
    dims = _check(hist_e, target_e, weights, "din_head_fused")
    B, L, D, A1, A2, F1, F2 = dims
    lib = _lib()
    device = hist_e.device
    out = torch.empty((B,), dtype=hist_e.dtype, device=device)
    bf16 = _is_bf16(hist_e)
    with torch.cuda.device(device):
        s = stream(device.index)
        if bf16 or not lib.din_head_fwd_tf32(L, D, A1, A2, F1, F2):
            code = lib.din_head_fwd(hist_e.data_ptr(), target_e.data_ptr(), _pointers(weights),
                                    out.data_ptr(), *dims, bf16, s)
            raise_on(lib.din_head_error_string, code, "din_head_fused")
            _counted(din_head_fused, hist_e.dtype)
            return out
        pooled = torch.empty((B, D), dtype=torch.float32, device=device)
        code = lib.din_head_fwd_pool(hist_e.data_ptr(), target_e.data_ptr(), _pointers(weights),
                                     pooled.data_ptr(), *dims, s)
        raise_on(lib.din_head_error_string, code, "din_head_fused (attention)")
        _counted(din_head_fused, hist_e.dtype)
        code = lib.din_head_fwd_fc(pooled.data_ptr(), target_e.data_ptr(), _pointers(weights),
                                   out.data_ptr(), *dims, s)
        raise_on(lib.din_head_error_string, code, "din_head_fused (fc)")
        _counted(din_head_fused, hist_e.dtype)
    return out


def din_head_fused_bwd(hist_e, target_e, weights, g):
    """Launch ``din_head_bwd_kernel``,
    ``din_head_bwd_fc_kernel`` and ``din_head_bwd_reduce_kernel``: the
    forward's inputs and the logit cotangent g [B] (f32 or bf16) -> (d hist_e,
    d target_e, the 14 weight gradients in their weights' shapes), all f32."""
    dims = _check(hist_e, target_e, weights, "din_head_fused_bwd")
    B, L, D, A1, A2, F1, F2 = dims
    device = hist_e.device
    check("g", g, DTYPES, 1, device)
    if g.shape[0] != B:
        raise ValueError(f"g {tuple(g.shape)} is not [B] = [{B}]")
    g = g.float()  # [B]: the kernel reads a float32 cotangent
    bf16 = _is_bf16(hist_e)
    lib = _lib()
    offsets = (I * _GRADS)()
    total = lib.din_head_grad_offsets(D, A1, A2, F1, F2, offsets)
    dhist = torch.empty((B, L, D), dtype=torch.float32, device=device)
    dtgt = torch.empty((B, D), dtype=torch.float32, device=device)
    grad = torch.empty((total,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        blocks = lib.din_head_bwd_blocks(*dims, bf16)
        if blocks < 1:
            raise RuntimeError("din_head_fused_bwd: no launch configuration for this card")
        part = torch.empty((blocks, total), dtype=torch.float32, device=device)
        rows = torch.empty((B * (2 * D + 2 * F1 + F2),), dtype=torch.float32, device=device)
        s = stream(device.index)
        code = lib.din_head_bwd(hist_e.data_ptr(), target_e.data_ptr(), _pointers(weights),
                                g.data_ptr(), dhist.data_ptr(), dtgt.data_ptr(), part.data_ptr(),
                                rows.data_ptr(), *dims, blocks, bf16, s)
        raise_on(lib.din_head_error_string, code, "din_head_fused_bwd")
        _counted(din_head_fused_bwd, hist_e.dtype)
        code = lib.din_head_bwd_fc(rows.data_ptr(), part.data_ptr(), B, D, A1, A2, F1, F2, blocks,
                                   bf16, s)
        raise_on(lib.din_head_error_string, code, "din_head_fused_bwd (fc)")
        _counted(din_head_fused_bwd, hist_e.dtype)
        code = lib.din_head_bwd_reduce(part.data_ptr(), grad.data_ptr(), blocks, total, s)
        raise_on(lib.din_head_error_string, code, "din_head_fused_bwd (reduce)")
        _counted(din_head_fused_bwd, hist_e.dtype)
    o = list(offsets)
    shapes = [(D, A1), (D, A1), (1, A1), (A1, A2), (1, A2), (A2, 1), (1, 1),
              (2 * D, F1), (1, F1), (F1, F2), (1, F2), (F2, 1), (1, 1)]
    views = [grad[at:at + r * c].view(r, c) for at, (r, c) in zip(o, shapes)]
    du1 = views[7]
    dweights = views[:7] + [du1[:D], du1[D:]] + views[8:]
    return (dhist, dtgt, *dweights)


def reset_launches() -> None:
    """Set both launchers' counts, in all and by dtype, to 0."""
    for fn in (din_head_fused, din_head_fused_bwd):
        fn.launches = 0
        fn.launches_by_dtype = {str(dtype).split(".")[1]: 0 for dtype in DTYPES}


reset_launches()
