"""Checked launcher of the DIN attention-pool kernel (``csrc/din_attention.cu``).

``din_attention_pool`` splits the attention MLP's first layer into wh and wt
(the concat decomposition, as the JAX wrapper does before its
``pallas_call``) and launches the kernel once, keeping a count of its launches
(``.launches``), raised by one per launch and nowhere else. float32 only, on
the device of ``hist_e``; the widths must be multiples of 4 and L at most 64.

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

SOURCE = "din_attention.cu"
MAX_HISTORY = 64  # kMaxHistory in csrc/din_common.cuh
_F32 = (torch.float32,)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.din_attention_fwd.argtypes = [P, P, P, P, P, P, P, P, P, LL, I, I, I, I, P]
    lib.din_attention_fwd.restype = I
    lib.din_attention_error_string.argtypes = [I]
    lib.din_attention_error_string.restype = ctypes.c_char_p
    lib.din_attention_max_history.argtypes = []
    lib.din_attention_max_history.restype = I
    if lib.din_attention_max_history() != MAX_HISTORY:
        raise RuntimeError("din_attention.cu and its launcher disagree on the longest history")
    return lib


def din_attention_pool(hist_e, target_e, att):
    """Launch ``din_pool_kernel``: hist_e [B, L, D], target_e [B, D] f32 and
    the attention MLP ``att`` (3D -> A1 -> A2 -> 1, f32) -> pooled [B, D] f32."""
    device = hist_e.device
    require_cuda("din_attention_pool", device)
    check("hist_e", hist_e, _F32, 3, device)
    check("target_e", target_e, _F32, 2, device)
    B, L, D = hist_e.shape
    if len(att) != 3 or any("b" not in layer for layer in att[:2]):
        raise ValueError("din_attention_pool takes an attention MLP of three biased layers")
    w1, b1, w2, b2, w3 = att[0]["w"], att[0]["b"], att[1]["w"], att[1]["b"], att[2]["w"]
    A1, A2 = w1.shape[1], w2.shape[1]
    for name, t, shape in (("att.0.w", w1, (3 * D, A1)), ("att.0.b", b1, (A1,)),
                           ("att.1.w", w2, (A1, A2)), ("att.1.b", b2, (A2,)),
                           ("att.2.w", w3, (A2, 1))):
        check(name, t, _F32, len(shape), device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if tuple(target_e.shape) != (B, D):
        raise ValueError(f"target_e {tuple(target_e.shape)} is not [B, D] = [{B}, {D}]")
    if B < 1 or not 1 <= L <= MAX_HISTORY:
        raise ValueError(f"need B={B} >= 1 and 1 <= L={L} <= {MAX_HISTORY}")
    if any(n < 4 or n % 4 for n in (D, A1, A2)):
        raise ValueError(f"widths D={D}, A=({A1}, {A2}) must be multiples of 4")
    wh = (w1[:D] + w1[D:2 * D]).contiguous()
    wt = (w1[2 * D:] - w1[D:2 * D]).contiguous()
    args = (hist_e, target_e, wh, wt, b1, w2, b2, w3)
    if any(t.data_ptr() % 16 for t in args):
        raise ValueError("din_attention_pool: every tensor must start on a 16-byte boundary")
    lib = _lib()
    out = torch.empty((B, D), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = lib.din_attention_fwd(*(t.data_ptr() for t in args), out.data_ptr(), B, L, D, A1,
                                     A2, stream(device.index))
    raise_on(lib.din_attention_error_string, code, "din_attention_pool")
    din_attention_pool.launches += 1
    return out


din_attention_pool.launches = 0
