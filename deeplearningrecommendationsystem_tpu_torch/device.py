"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. A machine
without CUDA raises here instead of silently running on the CPU; the CPU is
used only when the caller asks for it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises if it is CUDA and CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor is on the CPU, False if the first one is on CUDA
    (a kernel launcher then checks the rest); raises for any other device.

    The kernel wrappers dispatch on this alone: CPU tensors take the plain
    PyTorch version, CUDA tensors launch the kernel or raise.
    """
    dev = tensors[0].device.type
    if dev == "cuda":
        return False
    if all(t.device.type == "cpu" for t in tensors):
        return True
    raise ValueError(f"tensors on {[str(t.device) for t in tensors]}: need all on cpu or cuda")
