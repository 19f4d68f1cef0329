"""The initial weights, made on the device from the seed.

The reference of each model lists its parameters (name, shape, and the
distribution the model's source draws it from); the weights are two draws
from one generator on the device, every normal number in one call and every
uniform one in another, cut into the leaves by name and scaled. Both sides
start from these same tensors.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

Spec = Tuple[str, tuple, str, float]  # name, shape, "normal" | "uniform", std or bound


def draw(specs: Sequence[Spec], seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``specs``: "normal" leaves N(0, scale^2),
    "uniform" leaves U(-scale, scale)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = {k: sum(_numel(s) for _, s, kind, _ in specs if kind == k)
             for k in ("normal", "uniform")}
    unknown = {kind for _, _, kind, _ in specs} - set(sizes)
    if unknown:
        raise ValueError(f"unknown initialisers {sorted(unknown)}")
    pools = {"normal": torch.randn(sizes["normal"], generator=g, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=g, device=device)}
    offsets = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, kind, scale in specs:
        n = _numel(shape)
        x = pools[kind][offsets[kind]:offsets[kind] + n].reshape(shape)
        offsets[kind] += n
        out[name] = x * scale if kind == "normal" else (2.0 * x - 1.0) * scale
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters, whose names and shapes
    must be the same."""
    named = dict(model.named_parameters())
    mine = {k: tuple(v.shape) for k, v in named.items()}
    theirs = {k: tuple(v.shape) for k, v in weights.items()}
    if mine != theirs:
        raise ValueError(f"the model's parameters {mine} differ from the reference's {theirs}")
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(weights[name])
