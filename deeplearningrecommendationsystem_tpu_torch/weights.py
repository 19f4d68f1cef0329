"""Carry a model's weights across from the JAX package.

The two packages draw different numbers from the same seed, so a test that
holds the port against the JAX package gives both the same weights: the JAX
params pytree, as NumPy arrays, copied into the port's module. Each model
class names how its state-dict entries come from the pytree; a later model
adds its mapping to ``_FROM_JAX``.

``opt_state_from_jax`` does the same for the optimizer: it turns an optax Adam
state (``ScaleByAdamState``: ``count``, ``mu``, ``nu``, alone or inside the
``torch_adam`` chain) into the port's Adam state by param name, the form
``Trainer.fit(opt_state=...)`` resumes from. It reads the state by its
attributes, so this module imports neither JAX nor optax.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

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


def _adam_state(opt_state: Any):
    """The first node of ``opt_state`` (an optax state: nested tuples) that
    carries Adam's ``count``, ``mu`` and ``nu``."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def opt_state_from_jax(model: nn.Module, opt_state: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's Adam state for ``model`` from the JAX trainer's optax state:
    {param name: {"step", "exp_avg", "exp_avg_sq"}}, the moments mapped as
    ``params_from_jax`` maps the params."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise TypeError("no Adam state (count, mu, nu) in the given optax state")
    try:
        to_state = _FROM_JAX[type(model)]
    except KeyError:
        raise TypeError(f"no JAX weight mapping for {type(model).__name__}") from None
    mu, nu = to_state(adam.mu), to_state(adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    return {
        name: {
            "step": step.clone(),
            "exp_avg": torch.from_numpy(np.array(mu[name], dtype=np.float32)),
            "exp_avg_sq": torch.from_numpy(np.array(nu[name], dtype=np.float32)),
        }
        for name in mu
    }
