"""Rejection-free uniform negative sampling on the device.

The JAX package's ``sampling/negative.py`` on PyTorch, with the same
inverse-CDF design in place of the reference's host-side rejection loop:

  1. ``allowed = ~excluded``                    bool [U, I]
  2. ``cdf = cumsum(allowed, dim=1)``           [U, I] (last column = count)
  3. draw ``r ~ UniformInt[0, count_u)``        per (user, slot)
  4. item = index of the (r+1)-th allowed item = searchsorted(cdf_u, r, right=True)

The distribution is uniform with replacement over each user's allowed items,
as in the reference. The uniform draws come from an explicit CPU
``torch.Generator`` seeded from ``seed`` and are then moved to the device, so
the same seed gives the same negatives on the CPU and on a card. They are not
``jax.random``'s draws: tests hold the port to the distribution's properties.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device


def negative_sample(
    generator: torch.Generator, excluded: torch.Tensor, num_negatives: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ``num_negatives`` uniform non-excluded items per user.

    Args:
      generator: a CPU ``torch.Generator``; it advances by U * num_negatives draws.
      excluded: bool [U, I] on the device, True where the pair must not be sampled.
      num_negatives: draws per user (with replacement, like the reference).

    Returns:
      (users [U*negs] int32, items [U*negs] int32) on ``excluded``'s device,
      ordered user-major (the reference's emission order).
    """
    num_users = excluded.shape[0]
    cdf = torch.cumsum((~excluded).to(torch.int64), dim=1)  # [U, I]
    counts = cdf[:, -1:]  # [U, 1]
    u01 = torch.rand((num_users, num_negatives), generator=generator).to(excluded.device)
    # r in [0, count_u) per slot; count == 0 cannot happen on ml-100k
    r = torch.floor(u01 * counts.clamp_min(1)).to(torch.int64)
    r = torch.minimum(r, (counts - 1).clamp_min(0))
    items = torch.searchsorted(cdf, r, right=True)
    users = torch.arange(num_users, dtype=torch.int32, device=excluded.device)
    users = users[:, None].expand(num_users, num_negatives)
    return users.reshape(-1), items.reshape(-1).to(torch.int32)


class NegativeSampler:
    """Holds the exclusion mask on ``device`` and returns host-side split dicts."""

    def __init__(self, excluded: np.ndarray, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.excluded = torch.as_tensor(np.asarray(excluded, dtype=bool), device=self.device)
        self._generator = torch.Generator().manual_seed(seed)

    def sample(self, num_negatives: int):
        users, items = negative_sample(self._generator, self.excluded, num_negatives)
        users, items = users.cpu().numpy(), items.cpu().numpy()
        return {
            "user": users,
            "item": items,
            "rating": np.zeros(len(users), dtype=np.float32),
        }
