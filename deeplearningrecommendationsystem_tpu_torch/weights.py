"""Carry a model's weights across from the JAX package.

The two packages draw different numbers from the same seed, so a test that
holds the port against the JAX package gives both the same weights: the JAX
params pytree, as NumPy arrays, copied into the port's module. Each model
class names how its state-dict entries come from the pytree; a later model
adds its mapping to ``_FROM_JAX``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.models.mf import MatrixFactorization


def _mf(params: Mapping) -> Dict[str, np.ndarray]:
    return {"user": params["user"], "item": params["item"]}  # [U, D], [I, D]


_FROM_JAX: Dict[type, Callable[[Mapping], Dict[str, np.ndarray]]] = {
    MatrixFactorization: _mf,
}


def params_from_jax(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy the JAX params pytree ``params`` into ``model`` in place, on the
    model's device and dtype; returns the model."""
    try:
        to_state = _FROM_JAX[type(model)]
    except KeyError:
        raise TypeError(f"no JAX weight mapping for {type(model).__name__}") from None
    current = model.state_dict()
    state = {}
    for name, array in to_state(params).items():
        array = np.asarray(array)
        if tuple(array.shape) != tuple(current[name].shape):
            raise ValueError(
                f"{name}: JAX shape {array.shape} != port shape {tuple(current[name].shape)}"
            )
        state[name] = torch.from_numpy(np.array(array, copy=True))
    model.load_state_dict(state, strict=True)
    return model
