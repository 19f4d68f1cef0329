"""Analytic comm/compute model for data-parallel weak scaling on H100 cards.

The JAX package's ``runtime/scaling_model.py`` for the port, with the same
first-principles model:

  step_time(n) = max(compute_time, hbm_time) + allreduce_time(n)
  allreduce_time(n) = 2 * (n - 1) / n * grad_bytes / link_bw   (ring)

The step's cost comes from the program itself, as the JAX package takes it
from XLA's cost analysis: :func:`program_costs` runs the step once under
``torch.utils.flop_counter.FlopCounterMode`` (FLOPs) and a
``TorchDispatchMode`` that sums the bytes of every dispatched op's tensor
inputs and outputs, views skipped (each op reading its inputs and writing
its outputs once: an overcount of what fused kernels move, as XLA's "bytes
accessed" is, so ``hbm_ms`` is an upper bound on the memory term).

``H100`` holds one NVIDIA H100 SXM card's dense peak rates and memory rate,
the bounds ``PERF.md`` §6 uses (the datasheet's: 67 TFLOP/s float32 on the
CUDA cores, 495 TF32 and 989 bf16 on the tensor cores, 3.35 TB/s of HBM3);
``nvlink_gbps`` is the datasheet's NVLink 4 rate, 450 GB/s a direction, not
a measurement (the machine the port is measured on has one card). No rate
here is de-rated; the compute term is the least time the step's FLOPs take,
and the memory term, from the overcounted bytes, may exceed the least time
its traffic takes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

H100 = {
    "flops_f32": 67e12,     # float32 on the CUDA cores
    "flops_tf32": 495e12,   # TF32 on the tensor cores (dense)
    "flops_bf16": 989e12,   # bf16 on the tensor cores (dense)
    "hbm_gbps": 3.35e12,    # HBM3, bytes/s
    "nvlink_gbps": 450e9,   # NVLink 4, bytes/s a direction: datasheet, not measured
}
_PEAK = {"f32": "flops_f32", "tf32": "flops_tf32", "bf16": "flops_bf16"}


def _is_view(func) -> bool:
    """Whether ``func`` returns a view of an input (``t``, ``expand``,
    ``detach``, ...): it moves no memory. An in-place op's result aliases its
    input too, but is written."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every dispatched op's tensor inputs and outputs,
    views skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _is_view(func):
            return out
        leaves, _ = tree_flatten((args, kwargs or {}, out))
        self.bytes += sum(t.numel() * t.element_size() for t in leaves
                          if isinstance(t, torch.Tensor))
        return out


def program_costs(fn, *args, **kwargs) -> Dict[str, float]:
    """FLOPs and bytes moved of one call of ``fn(*args, **kwargs)`` (a
    training step: forward, backward and update), counted as it runs."""
    bytes_mode = _ByteCounter()
    flops_mode = FlopCounterMode(display=False)
    with flops_mode, bytes_mode:
        fn(*args, **kwargs)
    return {"flops": float(flops_mode.get_total_flops()), "hbm_bytes": float(bytes_mode.bytes)}


def grad_bytes_of(params: Any) -> int:
    """Bytes of one gradient of ``params`` (a dict of tensors, or an iterable)."""
    leaves = params.values() if isinstance(params, dict) else params
    return sum(p.numel() * p.element_size() for p in leaves)


def predict_weak_scaling(
    flops: float,
    hbm_bytes: float,
    grad_bytes: float,
    n_devices: int,
    chip: Optional[Dict[str, float]] = None,
    dtype: str = "f32",
) -> Dict[str, float]:
    """Expected per-step breakdown + weak-scaling efficiency at n devices.

    Weak scaling: per-device batch fixed, so per-device compute/HBM time is
    constant in n while the ring allreduce adds 2(n-1)/n * grad_bytes / link.
    ``chip`` defaults to :data:`H100`; a dict with the JAX package's keys
    (``flops_f32``, ``flops_bf16``, ``hbm_gbps``, ``ici_gbps``) gives the JAX
    function's numbers.
    """
    chip = chip or H100
    peak = chip[_PEAK.get(dtype, "flops_f32")]
    link = chip.get("nvlink_gbps", chip.get("ici_gbps"))
    t_compute = flops / peak
    t_hbm = hbm_bytes / chip["hbm_gbps"]
    t_local = max(t_compute, t_hbm)
    t_comm = 0.0
    if n_devices > 1:
        t_comm = 2.0 * (n_devices - 1) / n_devices * grad_bytes / link
    t_step = t_local + t_comm
    return {
        "n_devices": n_devices,
        "compute_ms": t_compute * 1e3,
        "hbm_ms": t_hbm * 1e3,
        "allreduce_ms": t_comm * 1e3,
        "step_ms": t_step * 1e3,
        "comm_fraction": t_comm / t_step if t_step else 0.0,
        "weak_scaling_efficiency": t_local / t_step if t_step else 1.0,
    }
