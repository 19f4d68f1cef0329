"""Parameter initialisers and the linear layer (the JAX package's ``ops/linear.py``).

Initialisation matches the reference: Xavier-normal embedding tables, and
linear layers with weight and bias drawn from U(-1/sqrt(fan_in),
1/sqrt(fan_in)) (torch's ``nn.Linear`` default). A linear layer is a dict
``{"w": [d_in, d_out], "b": [d_out]}``, the JAX pytree's layout, so
``linear`` takes the port's parameters and the JAX package's alike.

The draws differ from ``jax.random``'s for the same seed; tests that need
both packages to hold the same weights copy them across (``weights.py``).
``mlp_init`` and ``mlp`` are DIN's two-hidden-layer nets; ``relu_stack`` is the
tower of DeepFM, WideDeep, NFM, PNN and DCN.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import torch


def embedding_init(generator: torch.Generator, num: int, dim: int,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Xavier-normal [num, dim] embedding table, std = sqrt(2 / (num + dim)),
    drawn from ``generator`` on the generator's device."""
    std = (2.0 / (num + dim)) ** 0.5
    return std * torch.randn(
        (num, dim), generator=generator, dtype=dtype, device=generator.device
    )


def uniform(generator: torch.Generator, shape, bound: float, dtype) -> torch.Tensor:
    """U(-bound, bound) of ``shape``, drawn from ``generator`` on its device."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return (2.0 * u - 1.0) * bound


def linear_init(generator: torch.Generator, d_in: int, d_out: int, bias: bool = True,
                dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """``{"w": [d_in, d_out]}`` and, with ``bias``, ``"b": [d_out]``, each
    U(-1/sqrt(d_in), 1/sqrt(d_in))."""
    bound = 1.0 / (d_in ** 0.5)
    p = {"w": uniform(generator, (d_in, d_out), bound, dtype)}
    if bias:
        p["b"] = uniform(generator, (d_out,), bound, dtype)
    return p


def linear(p: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)``."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_init(generator: torch.Generator, dims: Sequence[int],
             dtype: torch.dtype = torch.float32) -> List[Dict[str, torch.Tensor]]:
    """A stack of ``linear_init`` layers with dims [d0, d1, ..., dn]."""
    return [linear_init(generator, d_in, d_out, dtype=dtype)
            for d_in, d_out in zip(dims[:-1], dims[1:])]


def mlp(layers: Sequence[Mapping[str, torch.Tensor]], x: torch.Tensor,
        final_activation: bool = False) -> torch.Tensor:
    """Linear -> ReLU between layers; the last layer linear unless
    ``final_activation``."""
    for p in layers[:-1]:
        x = torch.relu(linear(p, x))
    x = linear(layers[-1], x)
    return torch.relu(x) if final_activation else x


def relu_stack(layers: Sequence[Mapping[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """Linear -> ReLU for EVERY layer, the last included: the reference's tower
    (model/widedeep.py:51-57, model/deepcross.py:21-31)."""
    for p in layers:
        x = torch.relu(linear(p, x))
    return x
