"""Replays the JAX package's minibatch order in the port's tests.

``jax.random`` cannot be replayed in torch, so the port draws each epoch's
order on the host (``train/minibatch.py::epoch_order``). A test that holds a
minibatch run against the JAX package's replaces that function with
``jax_order(key)``: the JAX trainers' own draws for ``key``, ``split(key)``
-> ``split(shuffle, epochs)`` -> ``permutation(erng, n)[: nb * bs]``
(``train/minibatch.py:43-71`` and ``train/sparse_trainer.py`` of the JAX
package).
"""

import jax
import numpy as np
import torch


def jax_order(key):
    """An ``epoch_order(rng, n, epochs, batch_size)`` that returns the JAX
    minibatch trainers' permutations for ``key``, int64 [epochs, nb, bs]."""
    def order(rng, n, epochs, batch_size):
        _, shuffle = jax.random.split(key)
        nb = n // batch_size
        return torch.stack([
            torch.from_numpy(np.asarray(jax.random.permutation(e, n))[: nb * batch_size]
                             .astype(np.int64)).view(nb, batch_size)
            for e in jax.random.split(shuffle, epochs)])
    return order
