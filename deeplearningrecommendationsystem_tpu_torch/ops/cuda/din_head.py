"""Checked launchers of the fused DIN head kernels (``csrc/din_head.cu``).

``din_head_fused``, the forward: in bfloat16 one launch of ``din_fwd_kernel``
(its products on the tensor cores, m16n8k16), which under
``din_head_fused_pooled`` also writes the pooled rows [B, D] (float32) that the
backward's split takes (then, for fc layers wider than the library's
``kTensorPoolF1`` or ``kTensorPoolF2``, its attention unit sums on CUDA cores
in k order); in
float32 two launches
on the tensor cores in float32 accuracy (3xTF32), the attention stage
(``din_pool_kernel`` with b3, into a pooled [B, D] buffer) and the fc head
(``din_head_fc_kernel``), or, at widths whose tiles do not fit those two
kernels (``fits`` without ``TF32_FWD``), one launch of ``din_fwd_kernel`` on
CUDA cores (``din_head_fused_pooled`` also returns the pooled buffer).
``din_head_fused_bwd``, the backward, split where the widths fit
(``SPLIT_F32`` for float32, ``SPLIT_BF16`` for bfloat16): five launches, the
pooled rows again (float32: the attention stage; bf16: ``din_fwd_kernel``;
none when the forward's are given: four), the fc head's backward on the tensor
cores (float32: ``din_head_bwd_fc_head_kernel``, 3xTF32, or, where its tile
does not fit, ``din_head_bwd_fc_stream_kernel<float>``; bf16:
``din_head_bwd_fc_stream_kernel<bf16>``, m16n8k16: [dpooled | dt], its bias
gradients and the rows below), the attention unit's backward
(``din_head_bwd_att_kernel``: d hist, d target, one slot of weight-gradient
sums per block; its recompute on CUDA cores, its products there in float32 and
on the tensor cores in bf16), the fc head's two large weight gradients from
those rows (``din_head_bwd_fc_kernel``) and the sum of the slots in block
order (``din_head_bwd_reduce_kernel``); in float32 at widths without the split
bit, three launches: ``din_head_bwd_kernel`` (the whole head's tile walk,
which writes d hist, d target, the slots and the fc head's rows), then the last
two; bf16 without ``SPLIT_BF16`` raises before any launch. Each
keeps a count of its launches (``.launches``), raised by one per kernel launch
and nowhere else, and the same count by the inputs' dtype
(``.launches_by_dtype``). Both take float32 or bfloat16, one dtype for hist_e,
target_e and the 14 weights (the JAX kernel's single compute dtype; a mix
raises), on the device of ``hist_e``; the widths must be multiples of 4, the fc
widths at most 2048 and L at most 64. The forward returns logits in the
inputs' dtype; the backward takes a cotangent g of either dtype (widened to
float32 for the kernel) and returns float32 gradients.

``fits`` says from the widths alone which of the kernels' tile layouts fit a
block's shared memory, mirroring ``din_head_fits`` of the library; DIN takes
its kernels only where every launch it sends fits (``ops/din_head.py::
kernel_route``).

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
MAX_FC = 2048  # the fc widths din_head_bwd_fc_kernel takes: 4 columns a thread of 512
SMEM_LIMIT = 232_448  # kSmemLimit: shared memory a block may use on Hopper
# din_head_fits' bits: the tile layouts of the forward (din_fwd_kernel), the
# backward (din_head_bwd_kernel), the window pool (din_pool.cuh), the float32
# forward on the tensor cores, and the backward's split in float32 and in bf16
FWD, BWD, POOL, TF32_FWD, SPLIT_F32, SPLIT_BF16 = 1, 2, 4, 8, 16, 32
DTYPES = (torch.float32, torch.bfloat16)
_GRADS = 13  # the slot's blocks: u1p and u1t share one, u1 [2D, F1]


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load(SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``din_head.cu``) with its entry points' argument and
    result types set, checked against this launcher."""
    W = ctypes.POINTER(P)
    lib.din_head_fwd.argtypes = [P, P, W, P, P, LL, I, I, I, I, I, I, I, P]
    lib.din_head_fwd.restype = I
    lib.din_head_bwd_blocks.argtypes = [LL, I, I, I, I, I, I, I]
    lib.din_head_bwd_blocks.restype = I
    lib.din_head_bwd.argtypes = [P, P, W, P, P, P, P, P, LL, I, I, I, I, I, I, I, I, P]
    lib.din_head_bwd.restype = I
    lib.din_head_bwd_fc.argtypes = [P, P, LL, I, I, I, I, I, I, I, P]
    lib.din_head_bwd_fc.restype = I
    lib.din_head_bwd_reduce.argtypes = [P, P, I, I, P]
    lib.din_head_bwd_reduce.restype = I
    lib.din_head_fits.argtypes = [I, I, I, I, I, I]
    lib.din_head_fits.restype = I
    lib.din_head_bwd_fc_head.argtypes = [P, P, W, P, P, P, P, LL, I, I, I, I, I, I, I, I, P]
    lib.din_head_bwd_fc_head.restype = I
    lib.din_head_bwd_att.argtypes = [P, P, W, P, P, P, P, LL, I, I, I, I, I, I, I, I, P]
    lib.din_head_bwd_att.restype = I
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


def _r4(n: int) -> int:
    return (n + 3) & ~3


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _stride8(n: int) -> int:
    return n + (8 - n % 32 + 32) % 32


def _head_floats(L, D, A1, A2, F1, F2, R, backward) -> int:
    """din::make_layout's total (floats) for a tile of R rows."""
    M = R * L
    fc = _r4(R * (F1 + 4)) + R * (F2 + 4)
    regions = [M * (D + 4), R * (2 * D + 4), M * (A1 + 4)] + [M * (A2 + 4)] * backward + [
        R * (A1 + 4), max(M * (A2 // 4), fc), M] + [M, R * (2 * D + 4), R] * backward
    return sum(_r4(n) for n in regions)


def _pool_floats(L, D, A1, A2, R, on_chip) -> int:
    """dinpool::make_layout's total (floats)."""
    Mp, Rp, Dk = _up(R * L, 16), _up(R, 16), _up(D, 8)
    A1p, A2p = _up(A1, 64), _up(A2, 64)
    ldh, ldt = _stride8(Dk), _stride8(A1p)
    weights = [4 * A1p * _up(Dk // 2, 8), 4 * A2p * _up(A1p // 2, 8), A1p, A2p, A2p] * on_chip
    return sum(_up(n, 4) for n in weights + [2 * Mp * ldh, 2 * Rp * ldh, 2 * R * ldt, 2 * Mp])


def _fc_floats(D, F1, F2, R) -> int:
    """make_fc_layout's total (floats), the float32 forward's fc head."""
    return R * _stride8(2 * D) + R * _stride8(F1) + _r4(R * -(-F2 // 16))


def _fc_stream_floats(D, F1, F2, R, bf16) -> int:
    """make_fc_stream_layout's total (floats), the streamed fc head's backward."""
    return sum(_r4(n) for n in (R * (128 + (16 if bf16 else 8)), R * 264, R * (2 * D + 4) * bf16, R,
                                F1, F2, F2, 1))


def fits(L: int, D: int, A1: int, A2: int, F1: int, F2: int) -> int:
    """``din_head_fits`` of the library, from the widths alone: the bits FWD,
    BWD, POOL, TF32_FWD, SPLIT_F32 and SPLIT_BF16 of the tile layouts whose
    smallest tile (the fewest rows each takes) fits in SMEM_LIMIT bytes; 0 for
    widths the kernels refuse (L past MAX_HISTORY, widths not multiples of 4).
    The split takes the attention unit's tile, the streamed fc head's and the
    stage of the pooled rows (float32: TF32_FWD; bf16: FWD)."""
    if not 1 <= L <= MAX_HISTORY or any(n < 4 or n % 4 for n in (D, A1, A2, F1, F2)):
        return 0

    def ok(floats):
        return 4 * floats <= SMEM_LIMIT

    fwd, bwd = ok(_head_floats(L, D, A1, A2, F1, F2, 1, 0)), ok(_head_floats(L, D, A1, A2, F1, F2, 1, 1))
    pool = ok(_pool_floats(L, D, A1, A2, 1, False))
    tf32_fwd = pool and ok(_fc_floats(D, F1, F2, 16))
    att = ok(_head_floats(L, D, A1, A2, 4, 4, 1, 1))
    split_f32 = tf32_fwd and att and ok(_fc_stream_floats(D, F1, F2, 16, False))
    split_bf16 = fwd and att and ok(_fc_stream_floats(D, F1, F2, 16, True))
    return (FWD * fwd | BWD * bwd | POOL * pool | TF32_FWD * tf32_fwd | SPLIT_F32 * split_f32
            | SPLIT_BF16 * split_bf16)


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
    CUDA cores where the widths do not fit the pair (no ``TF32_FWD``)."""
    return din_head_fused_pooled(hist_e, target_e, weights, keep_pooled=False)[0]


def din_head_fused_pooled(hist_e, target_e, weights, keep_pooled=True):
    """``din_head_fused``, and the pooled rows [B, D] (float32) that it wrote
    (bf16: ``din_fwd_kernel``; float32: its attention stage), or None where the
    float32 forward takes ``din_fwd_kernel<float>`` or, in bf16, where
    ``keep_pooled`` is False: ``din_head_fused_bwd`` takes them in place of
    launching that stage again, which would write the same bits."""
    dims = _check(hist_e, target_e, weights, "din_head_fused")
    B, L, D, A1, A2, F1, F2 = dims
    lib = _lib()
    device = hist_e.device
    out = torch.empty((B,), dtype=hist_e.dtype, device=device)
    bf16 = _is_bf16(hist_e)
    with torch.cuda.device(device):
        s = stream(device.index)
        if bf16 or not lib.din_head_fits(L, D, A1, A2, F1, F2) & TF32_FWD:
            pooled = (torch.empty((B, D), dtype=torch.float32, device=device)
                      if bf16 and keep_pooled else None)
            code = lib.din_head_fwd(hist_e.data_ptr(), target_e.data_ptr(), _pointers(weights),
                                    out.data_ptr(), None if pooled is None else pooled.data_ptr(),
                                    *dims, bf16, s)
            raise_on(lib.din_head_error_string, code, "din_head_fused")
            _counted(din_head_fused, hist_e.dtype)
            return out, pooled
        pooled = torch.empty((B, D), dtype=torch.float32, device=device)
        code = lib.din_head_fwd_pool(hist_e.data_ptr(), target_e.data_ptr(), _pointers(weights),
                                     pooled.data_ptr(), *dims, s)
        raise_on(lib.din_head_error_string, code, "din_head_fused (attention)")
        _counted(din_head_fused, hist_e.dtype)
        code = lib.din_head_fwd_fc(pooled.data_ptr(), target_e.data_ptr(), _pointers(weights),
                                   out.data_ptr(), *dims, s)
        raise_on(lib.din_head_error_string, code, "din_head_fused (fc)")
        _counted(din_head_fused, hist_e.dtype)
    return out, pooled


def din_head_fused_bwd(hist_e, target_e, weights, g, pooled=None):
    """Launch the backward: the forward's inputs and the logit cotangent g [B]
    (f32 or bf16) -> (d hist_e, d target_e, the 14 weight gradients in their
    weights' shapes), all f32. Where the widths fit the split (``SPLIT_F32``,
    ``SPLIT_BF16``): the stage of the pooled rows (unless ``pooled``, the
    forward's from ``din_head_fused_pooled``, is given), the fc head's kernel,
    ``din_head_bwd_att_kernel``; else, in float32, ``din_head_bwd_kernel``;
    then ``din_head_bwd_fc_kernel`` and ``din_head_bwd_reduce_kernel``. bf16
    widths without ``SPLIT_BF16`` raise RuntimeError before any launch."""
    dims = _check(hist_e, target_e, weights, "din_head_fused_bwd")
    B, L, D, A1, A2, F1, F2 = dims
    device = hist_e.device
    check("g", g, DTYPES, 1, device)
    if g.shape[0] != B:
        raise ValueError(f"g {tuple(g.shape)} is not [B] = [{B}]")
    g = g.float()  # [B]: the kernel reads a float32 cotangent
    bf16 = _is_bf16(hist_e)
    lib = _lib()
    split = lib.din_head_fits(L, D, A1, A2, F1, F2) & (SPLIT_BF16 if bf16 else SPLIT_F32)
    if bf16 and not split:
        raise RuntimeError(f"din_head_fused_bwd: the bf16 backward's split takes no tile at L={L}, "
                           f"D={D}, A=({A1}, {A2}), F=({F1}, {F2}) (fits without SPLIT_BF16)")
    offsets = (I * _GRADS)()
    total = lib.din_head_grad_offsets(D, A1, A2, F1, F2, offsets)
    dhist = torch.empty((B, L, D), dtype=torch.float32, device=device)
    dtgt = torch.empty((B, D), dtype=torch.float32, device=device)
    grad = torch.empty((total,), dtype=torch.float32, device=device)
    w = _pointers(weights)
    with torch.cuda.device(device):
        blocks = lib.din_head_bwd_blocks(*dims, bf16)
        if blocks < 1:
            raise RuntimeError("din_head_fused_bwd: no launch configuration for this card")
        part = torch.empty((blocks, total), dtype=torch.float32, device=device)
        rows = torch.empty((B * (2 * D + 2 * F1 + F2),), dtype=torch.float32, device=device)
        s = stream(device.index)
        if split:
            if pooled is None:
                pooled = torch.empty((B, D), dtype=torch.float32, device=device)
                if bf16:
                    logits = torch.empty((B,), dtype=hist_e.dtype, device=device)
                    code = lib.din_head_fwd(hist_e.data_ptr(), target_e.data_ptr(), w,
                                            logits.data_ptr(), pooled.data_ptr(), *dims, 1, s)
                else:
                    code = lib.din_head_fwd_pool(hist_e.data_ptr(), target_e.data_ptr(), w,
                                                 pooled.data_ptr(), *dims, s)
                raise_on(lib.din_head_error_string, code, "din_head_fused_bwd (pooled rows)")
                _counted(din_head_fused_bwd, hist_e.dtype)
            else:
                check("pooled", pooled, (torch.float32,), 2, device)
                if tuple(pooled.shape) != (B, D):
                    raise ValueError(f"pooled {tuple(pooled.shape)} is not [B, D] = [{B}, {D}]")
            dpt = torch.empty((B, 2 * D), dtype=torch.float32, device=device)
            code = lib.din_head_bwd_fc_head(pooled.data_ptr(), target_e.data_ptr(), w, g.data_ptr(),
                                            dpt.data_ptr(), rows.data_ptr(), part.data_ptr(), *dims,
                                            blocks, bf16, s)
            raise_on(lib.din_head_error_string, code, "din_head_fused_bwd (fc head)")
            _counted(din_head_fused_bwd, hist_e.dtype)
            code = lib.din_head_bwd_att(hist_e.data_ptr(), target_e.data_ptr(), w, dpt.data_ptr(),
                                        dhist.data_ptr(), dtgt.data_ptr(), part.data_ptr(), *dims,
                                        blocks, bf16, s)
            raise_on(lib.din_head_error_string, code, "din_head_fused_bwd (attention unit)")
            _counted(din_head_fused_bwd, hist_e.dtype)
        else:
            code = lib.din_head_bwd(hist_e.data_ptr(), target_e.data_ptr(), w, g.data_ptr(),
                                    dhist.data_ptr(), dtgt.data_ptr(), part.data_ptr(),
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
