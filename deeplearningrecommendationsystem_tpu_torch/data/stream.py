"""Host-side streaming dataloader with device prefetch.

The JAX package's ``data/stream.py`` on PyTorch: for datasets that do not fit
on the device, the examples stay in host memory as NumPy arrays, each epoch
is shuffled on the host, and ``prefetch`` batches are kept in flight on the
device ahead of the consumer, so the copy of batch i + 1 overlaps the
compute on batch i. ``train/minibatch.py::fit_stream`` and
``train/sparse_trainer.py::fit_stream_sparse`` consume it (CLI
``--train-mode stream``).

The host order is ``np.random.default_rng(seed).permutation(n)``, the JAX
package's, so both packages see the same batches.

On a CUDA device a batch is copied into pinned host memory, then to the card
by a non-blocking copy on a side stream; the consumer's stream waits on that
copy before the batch is handed over, each device tensor is recorded on the
consumer's stream (its memory is not reused while the consumer may still read
it), and the pinned host batch is kept alive until its copy has completed. On
the CPU the batch is the NumPy batch as a tensor, with no pinning and no copy.

The JAX ``sharding`` argument places batches on a mesh. Here each rank runs
its own loader, every rank drawing the same order from the same seed, and a
``sharding`` (``parallel/mesh.py::data_sharding``) keeps this rank's block of
the rows of every batch (the batch size a multiple of the block count), so
only that block is copied to the device.
"""

from __future__ import annotations

import collections
import itertools
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device


def tree_map(fn, tree):
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _sharded(x, sharding):
    """This rank's block of the rows of every leaf of ``x`` (all of it with no
    ``sharding``)."""
    return x if sharding is None else tree_map(sharding.take, x)


def epoch_batches(
    rng: np.random.Generator, n: int, batch_size: int, drop_last: bool = True
) -> Iterator[np.ndarray]:
    """Shuffled index batches for one epoch (host side)."""
    perm = rng.permutation(n)
    end = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, end, batch_size):
        yield perm[i : i + batch_size]


class _CudaPut:
    """Pinned host copy, then a non-blocking copy on a side stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.pending: collections.deque = collections.deque()  # (event, host tensors)

    def __call__(self, x):
        host = tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)).pin_memory(), x)
        with torch.cuda.stream(self.stream):
            out = tree_map(lambda t: t.to(self.device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.pending.append((done, host))
        return out, done

    def hand_over(self, item):
        """The device batch, once the consumer's stream has waited on its copy."""
        out, done = item
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        tree_map(lambda t: t.record_stream(consumer), out)
        # a host batch is released only once its copy has completed
        while self.pending and self.pending[0][0].query():
            self.pending.popleft()
        return out


def _cpu_put(x):
    return tree_map(lambda a: torch.from_numpy(np.ascontiguousarray(a)), x)


def prefetch_to_device(
    iterator: Iterable[Any], size: int = 2, sharding=None,
    device: str | torch.device = "cuda",
) -> Iterator[Any]:
    """Keep ``size`` batches in flight on ``device`` ahead of the consumer.

    Each batch is a tree (tuples, lists, dicts) of NumPy arrays; it comes out
    as the same tree of tensors on ``device``; with ``sharding``, this rank's
    block of its rows.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        put = _CudaPut(dev)
        hand_over = put.hand_over
    else:
        put, hand_over = _cpu_put, (lambda item: item)
    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for x in itertools.islice(it, size):
        queue.append(put(_sharded(x, sharding)))
    while queue:
        yield hand_over(queue.popleft())
        nxt = next(it, None)
        if nxt is not None:
            queue.append(put(_sharded(nxt, sharding)))


class StreamingLoader:
    """Shuffled (batch, label) stream over host NumPy arrays, device-prefetched."""

    def __init__(
        self,
        arrays: Any,  # tree of NumPy arrays with equal leading dim
        batch_size: int,
        seed: int = 0,
        sharding=None,
        prefetch: int = 2,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.arrays = arrays
        self.n = tree_leaves(arrays)[0].shape[0]
        self.batch_size = batch_size
        if sharding is not None and batch_size % sharding.parts:
            raise ValueError(f"batch_size {batch_size} does not split into {sharding.parts} "
                             "blocks")
        self.sharding = sharding
        self._rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return self.n // self.batch_size

    def epoch(self) -> Iterator[Any]:
        def host_batches():
            for idx in epoch_batches(self._rng, self.n, self.batch_size):
                yield tree_map(lambda a: a[idx], self.arrays)

        return prefetch_to_device(host_batches(), self.prefetch, self.sharding,
                                  device=self.device)
