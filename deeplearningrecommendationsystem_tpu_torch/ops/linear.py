"""Parameter initialisers (the JAX package's ``ops/linear.py``)."""

from __future__ import annotations

import torch


def embedding_init(generator: torch.Generator, num: int, dim: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Xavier-normal [num, dim] embedding table, std = sqrt(2 / (num + dim)),
    drawn from ``generator`` on the generator's device.

    The draws differ from ``jax.random``'s for the same seed; tests that need
    both packages to hold the same weights copy them across (``weights.py``).
    """
    std = (2.0 / (num + dim)) ** 0.5
    return std * torch.randn(
        (num, dim), generator=generator, dtype=dtype, device=generator.device
    )
