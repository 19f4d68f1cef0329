"""The collectives of the parallel layer, and their transposes.

Every tensor the port moves between ranks goes through this file: a sum over
one axis's group, a tiled all-gather and a tiled reduce-scatter
(``dist.all_gather_into_tensor``, ``dist.reduce_scatter_tensor``), a
broadcast of small host objects, and the ``torch.autograd.Function``\\ s that
carry JAX's transposes through the backward:

* :func:`psum` -- the sum of a replicated output (the EP lookup's
  ``lax.psum``). Its backward is the **identity**: every rank of the group
  already holds the same cotangent. (``torch.distributed.nn.functional.
  all_reduce`` sums in its backward too, which would scale every table
  gradient by the group's size.)
* :func:`all_gather` and :func:`psum_scatter` -- each is the other's
  transpose (``lax.all_gather(tiled=True)`` <-> ``lax.psum_scatter(tiled=True)``).

Transports. NCCL moves CUDA tensors on the device. Gloo is a host transport:
it moves CPU tensors, and CUDA tensors are staged through host memory here (a
copy to the host, the collective, a copy back), which happens only because
the caller opened the group with ``backend="gloo"``. Nothing switches backend
on its own: any other pair of backend and device raises. A group of one rank
moves nothing: the sum and the gathers return their input.

``STATS`` counts, for this rank, the bytes handed to the transport (each
collective's input and output) and the bytes staged between a card and the
host; :func:`reset_stats` zeroes both.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List

import torch
import torch.distributed as dist

STATS: Dict[str, int] = {"moved_bytes": 0, "staged_bytes": 0, "calls": 0}


def reset_stats() -> None:
    for key in STATS:
        STATS[key] = 0


def group_size(group) -> int:
    return dist.get_world_size(group)


def world_group():
    """The default group: every rank."""
    return dist.group.WORLD


def _stages(group, t: torch.Tensor) -> bool:
    """Whether ``t`` is staged through host memory for ``group``'s transport;
    raises for a pair of backend and device with no transport."""
    backend, dev = dist.get_backend(group), t.device.type
    if (backend, dev) in (("nccl", "cuda"), ("gloo", "cpu")):
        return False
    if (backend, dev) == ("gloo", "cuda"):
        return True
    raise RuntimeError(
        f"no transport for {dev} tensors over {backend!r}: NCCL moves CUDA tensors, "
        "Gloo CPU tensors (and CUDA tensors through the host); open the group with "
        "the backend the tensors need")


def _collective(op, out_shape, x: torch.Tensor, group) -> torch.Tensor:
    """``op(out, inp, group=group)`` on a fresh ``out`` of ``out_shape``."""
    stage = _stages(group, x)
    inp = x.detach().cpu() if stage else x.detach().contiguous()
    out = torch.empty(out_shape, dtype=x.dtype, device=inp.device)
    with warnings.catch_warnings():  # the *_tensor names are deprecated from torch 2.13
        warnings.simplefilter("ignore", FutureWarning)
        op(out, inp, group=group)
    nbytes = inp.nbytes + out.nbytes
    STATS["moved_bytes"] += nbytes
    STATS["calls"] += 1
    if stage:
        STATS["staged_bytes"] += nbytes
        out = out.to(x.device)
    return out


def _all_reduce(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    out.copy_(inp)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, on every rank (no autograd)."""
    if group_size(group) == 1:
        return x
    return _collective(_all_reduce, x.shape, x, group)


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` [n, ...] concatenated along axis 0 in group order:
    [n * size, ...] (no autograd)."""
    size = group_size(group)
    if size == 1:
        return x
    return _collective(dist.all_gather_into_tensor, (x.shape[0] * size,) + tuple(x.shape[1:]),
                       x, group)


def reduce_scatter_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``i`` of the group-wide sum of ``x`` [n * size, ...] on the rank of
    group index ``i``: [n, ...] (no autograd)."""
    size = group_size(group)
    if size == 1:
        return x
    if x.shape[0] % size:
        raise ValueError(f"{x.shape[0]} rows do not split over {size} ranks")
    return _collective(dist.reduce_scatter_tensor, (x.shape[0] // size,) + tuple(x.shape[1:]),
                       x, group)


def sum_tensors_(tensors: List[torch.Tensor], group) -> None:
    """Sum every tensor of ``tensors`` over ``group`` in place, as one flat
    buffer a dtype (one collective each, whatever the count)."""
    if group_size(group) == 1 or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        summed = sum_over(flat, group)
        offset = 0
        for t in ts:
            t.copy_(summed[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_tiled(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_tiled(g.contiguous(), ctx.group), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_tiled(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_tiled(g.contiguous(), ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum`` of a replicated output: the sum over ``group``; identity backward."""
    if group_size(group) == 1:
        return x
    return _Psum.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``; its backward is :func:`psum_scatter`."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group)


def psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum_scatter(tiled=True)``; its backward is :func:`all_gather`."""
    if group_size(group) == 1:
        return x
    return _PsumScatter.apply(x, group)


def broadcast_object(obj: Any = None, src: int = 0, group=None) -> Any:
    """``obj`` of rank ``src`` on every rank (small host objects: a request)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
