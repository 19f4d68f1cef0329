"""Minibatch training: shuffled Adam epochs through the Trainer's step.

The JAX package's ``train/minibatch.py`` on PyTorch. ``fit_minibatch`` keeps
the dataset on the device and draws a fresh permutation each epoch;
``fit_stream`` keeps it in host memory and feeds the step through
``data/stream.py``'s prefetching loader. Both step with ``Trainer.train_step``
(``Trainer.loss_fn``: the ``compute_dtype`` policy and the auxiliary loss
apply as in full-batch training, the lookups' forward and backward are the
gather kernel pair) on the Trainer's Adam, train the model's parameters in
place, drop the trailing partial batch every epoch, and return
``history["train_loss"]`` [epochs], each epoch's mean step loss. The step
losses stay on the device until the end: no step waits for the host.

The JAX package compiles the whole run into one ``lax.scan`` and draws each
epoch's order with ``jax.random``, which torch cannot replay. Here the order
is drawn on the host by :func:`epoch_order`, from a CPU generator (the
caller's ``rng``: a seed or a CPU ``torch.Generator``), so a run on the card
and the same run on the CPU see the same batches; the model draws its initial
weights when it is built, as for ``Trainer.fit``. ``fit_stream``'s order is
the JAX package's NumPy order, bit for bit.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from deeplearningrecommendationsystem_tpu_torch.data.stream import StreamingLoader, tree_map
from deeplearningrecommendationsystem_tpu_torch.train.trainer import (
    OptState,
    Trainer,
    TrainResult,
    _to_device,
)


def host_generator(rng) -> torch.Generator:
    """A CPU generator from ``rng``: a seed, or a CPU ``torch.Generator`` (used as is)."""
    if isinstance(rng, torch.Generator):
        if rng.device.type != "cpu":
            raise ValueError(f"rng: a seed or a CPU torch.Generator, got one on {rng.device}")
        return rng
    return torch.Generator().manual_seed(int(rng))


def epoch_order(rng, n: int, epochs: int, batch_size: int) -> torch.Tensor:
    """[epochs, n // batch_size, batch_size] int64 row indices on the CPU: each
    epoch a permutation of ``range(n)`` from ``host_generator(rng)``, its
    trailing partial batch dropped."""
    gen = host_generator(rng)
    nb = n // batch_size
    if nb == 0:
        raise ValueError(f"batch_size {batch_size} larger than the dataset ({n} rows)")
    return torch.stack([torch.randperm(n, generator=gen)[: nb * batch_size].view(nb, batch_size)
                        for _ in range(epochs)])


def take_rows(batch: Any, idx: torch.Tensor) -> Any:
    """The rows ``idx`` of every tensor of the batch tree."""
    return tree_map(lambda a: a[idx], batch)


def _result(trainer: Trainer, epoch_losses) -> TrainResult:
    params = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    return TrainResult(params=params, history={"train_loss": torch.stack(epoch_losses)},
                       opt_state=trainer.opt_state())


def fit_minibatch(
    trainer: Trainer,
    rng,
    train: Tuple[Any, torch.Tensor],
    batch_size: int,
    params: Optional[dict] = None,
    opt_state: Optional[OptState] = None,
) -> TrainResult:
    """Shuffled minibatch Adam for ``trainer.config.epochs`` epochs; the data
    lives on the Trainer's device. ``params``/``opt_state`` resume."""
    batch, labels = _to_device(train, trainer.device)
    trainer._load(params, opt_state)
    order = epoch_order(rng, labels.shape[0], trainer.config.epochs, batch_size)
    order = order.to(trainer.device)
    epoch_losses = []
    for perm in order:
        losses = [trainer.train_step(take_rows(batch, idx), labels[idx])[0] for idx in perm]
        epoch_losses.append(torch.stack(losses).mean())
    return _result(trainer, epoch_losses)


def fit_stream(
    trainer: Trainer,
    rng,
    train: Tuple[Any, Any],  # tree of HOST NumPy arrays, equal leading dim
    batch_size: int,
    params: Optional[dict] = None,
    opt_state: Optional[OptState] = None,
    sharding=None,
    prefetch: int = 2,
    seed: int = 0,
) -> TrainResult:
    """Minibatch Adam fed by the host-streaming loader (``data/stream.py``):
    the dataset stays in host memory, shuffled there with ``seed``, and the
    device holds the model and ``prefetch`` batches. The same step as
    :func:`fit_minibatch`; only the batch source differs. ``rng`` is the JAX
    signature's initialisation key: the model already holds its weights.

    ``sharding`` (``parallel/mesh.py::data_sharding`` of the Trainer's mesh)
    streams each rank its block of every batch; the step is then the
    data-parallel one, the loss the mean over the whole batch."""
    del rng
    loader = StreamingLoader(train, batch_size, seed=seed, sharding=sharding,
                             prefetch=prefetch, device=trainer.device)
    if len(loader) == 0:
        raise ValueError(f"batch_size {batch_size} larger than the dataset ({loader.n} rows)")
    trainer._load(params, opt_state)
    denom = None
    if sharding is not None and sharding.parts > 1:
        denom = torch.tensor(float(batch_size), device=trainer.device)
    epoch_losses = []
    for _ in range(trainer.config.epochs):
        losses = [trainer.train_step(b, y, denom=denom)[0] for b, y in loader.epoch()]
        epoch_losses.append(torch.stack(losses).mean())
    return _result(trainer, epoch_losses)
