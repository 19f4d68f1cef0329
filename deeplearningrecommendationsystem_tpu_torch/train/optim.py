"""Optimizers with reference-matching semantics.

Every reference script trains with ``torch.optim.Adam(lr, weight_decay)``
(e.g. scripts/mf.py:66): classic L2 added to the gradient BEFORE the moment
estimates, not AdamW's decoupled decay. The JAX package rebuilds that with an
optax chain (``add_decayed_weights`` ahead of ``adam``); here it is the library
optimizer itself. Defaults (b1=.9, b2=.999, eps=1e-8) agree.
"""

from __future__ import annotations

from typing import Iterable

import torch


def torch_adam(params: Iterable[torch.Tensor], learning_rate: float,
               weight_decay: float = 0.0) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, weight_decay=weight_decay)
