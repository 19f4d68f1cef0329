"""Tracing and profiling hooks (the JAX package's ``runtime/profiler.py``).

* ``trace(log_dir)``: ``torch.profiler`` over the enclosed block, CPU and, on
  a CUDA machine, the card's kernels; writes one Chrome trace
  (``trace.json``, for Perfetto or chrome://tracing) into ``log_dir``.
* ``debug_nans(enable)``: autograd's anomaly mode with its NaN check. Unlike
  JAX's ``jax_debug_nans``, which raises at the first primitive whose output
  holds a NaN, forward or backward, anomaly mode checks the backward: it
  raises where a backward function returns a NaN gradient and names the
  forward op that made it (recording each op's traceback, so it is slow).
  A NaN that appears in the forward and never reaches a gradient passes.
* ``StepTimer``: wall-clock examples a second, in all and per card
  (``torch.cuda.device_count()``, 1 on a machine without CUDA).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Autograd's anomaly mode with its NaN check for the enclosed block."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)


class StepTimer:
    """Wall-clock examples/s accounting for training loops."""

    def __init__(self, examples_per_step: int, num_chips: Optional[int] = None):
        self.examples_per_step = examples_per_step
        self.num_chips = num_chips or max(torch.cuda.device_count(), 1)
        self.steps = 0
        self.elapsed = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed += time.perf_counter() - self._t0
        self.steps += 1
        return False

    @property
    def examples_per_sec(self) -> float:
        return self.steps * self.examples_per_step / max(self.elapsed, 1e-9)

    @property
    def examples_per_sec_per_chip(self) -> float:
        return self.examples_per_sec / self.num_chips
