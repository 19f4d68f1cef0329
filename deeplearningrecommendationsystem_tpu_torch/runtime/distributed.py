"""Multi-process runtime: one process per rank, as ``torchrun`` starts them.

The JAX package's ``runtime/distributed.py`` on ``torch.distributed``. JAX has
one controller per host driving every device; the port has one process per
rank (SPMD): every rank calls the same entry points on its own slice and gets
the same replicated result, and rank 0 reports.

* :func:`initialize` opens the default process group, from ``torchrun``'s
  environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) or
  from an explicit ``init_method`` (``tcp://host:port``, ``file:///path``),
  ``world_size`` and ``rank``. The transport is ``backend``: NCCL by default,
  Gloo only when the caller asks for it; nothing here switches it.
* :func:`is_primary` and :func:`host_local_slice` answer from the group's
  rank and size; without a process group, as the JAX package does in one
  process, rank 0 of 1.
* :func:`local_device` is this rank's device: ``cuda:{LOCAL_RANK}`` unless the
  caller names one (the CPU only when asked), raising without CUDA.
* :func:`spawn` runs a function on ``n`` ranks started with the ``spawn``
  method on this host, their group over a ``FileStore`` in a fresh temporary
  directory, under a deadline: when it runs out every rank is killed and the
  call raises, so a hung collective never hangs the caller. The function
  must live in a module the children can import (one that imports no JAX:
  they re-import it).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: str = "nccl",
    timeout_s: Optional[float] = None,
) -> None:
    """``dist.init_process_group`` for this rank. With no ``init_method`` the
    group comes from the ``torchrun`` environment (``env://``). Under NCCL the
    rank's card (:func:`local_device`) is made current first."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    kwargs = {"backend": backend, "init_method": init_method or "env://"}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(**kwargs)


def _rank_and_size() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on rank 0 (and without a process group): the rank that reports."""
    return _rank_and_size()[0] == 0


def host_local_slice(n: int) -> Tuple[int, int]:
    """[start, end) of this rank's contiguous shard of n examples; the last
    rank takes the remainder."""
    p, np_ = _rank_and_size()
    per = n // np_
    start = p * per
    end = n if p == np_ - 1 else start + per
    return start, end


def local_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` if given (``resolve_device``'s rule), else ``cuda:{LOCAL_RANK}``
    (LOCAL_RANK 0 outside ``torchrun``); raises where CUDA is absent."""
    if device is not None:
        return resolve_device(device)
    return resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")


def _rank_entry(rank: int, fn: Callable, world: int, root: str, backend: str, threads: int,
                args: Sequence[Any]) -> None:
    torch.set_num_threads(threads)
    initialize(init_method=f"file://{root}/store", world_size=world, rank=rank, backend=backend)
    try:
        torch.save(fn(rank, world, *args), os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (), deadline_s: float = 120.0,
          backend: str = "gloo", threads: int = 1) -> List[Any]:
    """``[fn(rank, nprocs, *args) for each rank]``, each rank a spawned process
    in one process group (``backend``, ``threads`` intra-op threads a rank).
    Raises if a rank fails, and kills every rank and raises ``TimeoutError``
    when ``deadline_s`` runs out."""
    root = tempfile.mkdtemp(prefix="ranks_")
    try:
        ctx = mp.start_processes(_rank_entry, args=(fn, nprocs, root, backend, threads, tuple(args)),
                                 nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} "
                                       f"ran past their {deadline_s:.0f} s deadline")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
