"""What every ctypes launcher shares: argument checks, the current stream, and
turning a nonzero CUDA error code into an exception."""

from __future__ import annotations

import ctypes

import torch

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float


def check(name: str, t: torch.Tensor, dtypes, ndim: int, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(name: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {device}")


def stream(index: int) -> int:
    """The current stream of CUDA device ``index`` as an integer handle for
    ctypes: the one ``torch.cuda.stream(...)`` selects, else the default.

    ``torch._C._cuda_getCurrentRawStream`` is the lookup PyTorch's own
    generated kernel launchers make; unlike ``torch.cuda.current_stream`` it
    builds no ``torch.cuda.Stream`` object."""
    return torch._C._cuda_getCurrentRawStream(index)


def raise_on(error_string, code: int, name: str) -> None:
    """Raise if ``code`` (a cudaError_t returned by a launch) is not 0."""
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({error_string(code).decode()})")
