"""Checked launchers of the AFM attention-pool kernels (``csrc/afm_attention.cu``).

``afm_attention_pool`` launches the forward kernel once.
``afm_attention_pool_bwd`` launches the backward kernel, which writes the
fields' gradient and per-block partial sums of dW, db and dh, and then the
kernel that sums the partials in block order: two launches. Each keeps a
count of its launches (``.launches``), raised by one per kernel launch and
nowhere else. Both take float32 only, on the device of ``fields``: 6 fields,
A at most 256 and any D at which a tile of one row fits in a block's shared
memory (the weights move from shared to device memory where they do not fit).

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

SOURCE = "afm_attention.cu"
NUM_FIELDS = 6  # kF in the source
MAX_ATTENTION = 256  # kMaxA in the source
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper
_F32 = (torch.float32,)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.afm_attention_fwd.argtypes = [P, P, P, P, P, LL, I, I, P]
    lib.afm_attention_fwd.restype = I
    lib.afm_attention_bwd_blocks.argtypes = [LL, I, I]
    lib.afm_attention_bwd_blocks.restype = I
    lib.afm_attention_bwd.argtypes = [P, P, P, P, P, P, P, P, P, LL, I, I, I, P]
    lib.afm_attention_bwd.restype = I
    lib.afm_attention_bwd_reduce.argtypes = [P, P, P, P, P, P, I, I, I, P]
    lib.afm_attention_bwd_reduce.restype = I
    for name in ("afm_attention_fwd_smem_bytes", "afm_attention_bwd_smem_bytes"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [I, I], ctypes.c_size_t
    lib.afm_attention_max_attention.argtypes = []
    lib.afm_attention_max_attention.restype = I
    lib.afm_attention_error_string.argtypes = [I]
    lib.afm_attention_error_string.restype = ctypes.c_char_p
    lib.afm_attention_num_fields.argtypes = []
    lib.afm_attention_num_fields.restype = I
    if lib.afm_attention_num_fields() != NUM_FIELDS:
        raise RuntimeError("afm_attention.cu and its launcher disagree on the number of fields")
    if lib.afm_attention_max_attention() != MAX_ATTENTION:
        raise RuntimeError("afm_attention.cu and its launcher disagree on the widest A")
    return lib


def _check_params(fields, att_w, att_b, att_h, name: str):
    """(B, D, A) after the device, dtype, shape and contiguity checks."""
    device = fields.device
    require_cuda(name, device)
    check("fields", fields, _F32, 3, device)
    check("att_w", att_w, _F32, 2, device)
    check("att_b", att_b, _F32, 1, device)
    check("att_h", att_h, _F32, 2, device)
    B, Fn, D = fields.shape
    A = att_w.shape[1]
    if Fn != NUM_FIELDS or att_w.shape[0] != D or att_b.shape[0] != A or tuple(att_h.shape) != (A, 1):
        raise ValueError(f"shapes fields {tuple(fields.shape)} (6 fields), att_w "
                         f"{tuple(att_w.shape)}, att_b {tuple(att_b.shape)}, att_h {tuple(att_h.shape)}")
    if B < 1 or D < 1 or not 1 <= A <= MAX_ATTENTION:
        raise ValueError(f"need B={B} >= 1, D={D} >= 1, 1 <= A={A} <= {MAX_ATTENTION}")
    return B, D, A


def afm_attention_pool(fields, att_w, att_b, att_h):
    """Launch ``afm_pool_fwd_kernel``: fields [B, 6, D], att_w [D, A], att_b [A],
    att_h [A, 1] f32 -> pooled [B, D] f32."""
    B, D, A = _check_params(fields, att_w, att_b, att_h, "afm_attention_pool")
    lib = _lib()
    if lib.afm_attention_fwd_smem_bytes(D, A) > SMEM_LIMIT:
        raise ValueError(f"D={D}, A={A}: a tile of rows does not fit in a block's shared memory "
                         f"({SMEM_LIMIT} bytes)")
    device = fields.device
    out = torch.empty((B, D), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = lib.afm_attention_fwd(fields.data_ptr(), att_w.data_ptr(), att_b.data_ptr(),
                                     att_h.data_ptr(), out.data_ptr(), B, D, A,
                                     stream(device.index))
    raise_on(lib.afm_attention_error_string, code, "afm_attention_pool")
    afm_attention_pool.launches += 1
    return out


def afm_attention_pool_bwd(fields, att_w, att_b, att_h, g):
    """Launch ``afm_pool_bwd_kernel`` and ``afm_pool_bwd_reduce_kernel``: the
    forward's inputs and the pooled cotangent g [B, D] f32 -> (d_fields
    [B, 6, D], d_att_w [D, A], d_att_b [A], d_att_h [A, 1]), all f32."""
    B, D, A = _check_params(fields, att_w, att_b, att_h, "afm_attention_pool_bwd")
    device = fields.device
    check("g", g, _F32, 2, device)
    if tuple(g.shape) != (B, D):
        raise ValueError(f"g {tuple(g.shape)} is not [B, D] = [{B}, {D}]")
    lib = _lib()
    if lib.afm_attention_bwd_smem_bytes(D, A) > SMEM_LIMIT:
        raise ValueError(f"D={D}, A={A}: the backward's tile of one row does not fit in a block's "
                         f"shared memory ({SMEM_LIMIT} bytes)")
    de = torch.empty((B, NUM_FIELDS, D), dtype=torch.float32, device=device)
    dw = torch.empty((D, A), dtype=torch.float32, device=device)
    db = torch.empty((A,), dtype=torch.float32, device=device)
    dh = torch.empty((A, 1), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        blocks = lib.afm_attention_bwd_blocks(B, D, A)
        if blocks < 1:
            raise RuntimeError("afm_attention_pool_bwd: no launch configuration for this card")
        dw_part = torch.empty((blocks, D, A), dtype=torch.float32, device=device)
        db_part = torch.empty((blocks, A), dtype=torch.float32, device=device)
        dh_part = torch.empty((blocks, A), dtype=torch.float32, device=device)
        s = stream(device.index)
        code = lib.afm_attention_bwd(fields.data_ptr(), att_w.data_ptr(), att_b.data_ptr(),
                                     att_h.data_ptr(), g.data_ptr(), de.data_ptr(),
                                     dw_part.data_ptr(), db_part.data_ptr(), dh_part.data_ptr(),
                                     B, D, A, blocks, s)
        raise_on(lib.afm_attention_error_string, code, "afm_attention_pool_bwd")
        afm_attention_pool_bwd.launches += 1
        code = lib.afm_attention_bwd_reduce(dw_part.data_ptr(), db_part.data_ptr(),
                                            dh_part.data_ptr(), dw.data_ptr(), db.data_ptr(),
                                            dh.data_ptr(), blocks, D, A, s)
        raise_on(lib.afm_attention_error_string, code, "afm_attention_pool_bwd (reduce)")
        afm_attention_pool_bwd.launches += 1
    return de, dw, db, dh


afm_attention_pool.launches = 0
afm_attention_pool_bwd.launches = 0
