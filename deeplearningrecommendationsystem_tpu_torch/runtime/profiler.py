"""Tracing and profiling hooks: the port's one recorder, and the profiler.

The recorder: spans and counters inside the program.

* ``span(name)``: a context manager around one piece of the program's work.
  ``count(name, n)`` adds ``n`` to a named counter.
* ``recording()`` turns both on for the enclosed block and yields the
  ``Record``: the spans and counters stay in memory until the caller asks
  for them (``Record.export``, ``Record.summary``).
* Off by default, and free when off: ``span()`` returns one prebuilt no-op
  context and ``count()`` returns at once, calling no torch API and
  allocating nothing. A counter whose count takes work is computed only
  where ``is_recording()`` says so. Only a caller turns recording on; no
  environment variable or configuration field does.
* While recording, each span keeps its name, its parent (the span it was
  entered in), its host start and end in nanoseconds on ``time.time_ns``'s
  clock, which is the clock of ``torch.profiler``'s events (Unix-epoch
  time), and, where CUDA is initialised, a pair of timing events recorded
  on the current stream at its start and end. The events are read only when
  the record is exported, after the block: a span never synchronises. Their
  elapsed time is the span's device milliseconds: the time from the device
  reaching the span's start in the stream to its reaching the span's end.
* Each span also enters ``torch.profiler.record_function(name)``, so that
  under ``torch.profiler`` it is a host event of the trace, on the same
  clock as the kernels, and an idle stretch of the device is named by the
  program's span around it. It does so while a ``torch.profiler`` session is
  running even where recording is off, and then records nothing itself.

The spans and counters the port has, and what each covers:

* ``train.fit``: ``Trainer.fit`` as a whole; ``train.epoch``: each epoch of
  it; ``train.forward`` (the loss), ``train.backward`` (``backward()``
  and, under a mesh, the gradients' sums) and ``train.optimizer`` (the Adam
  step): each ``Trainer.train_step``;
* ``serve.refresh``: ``Recommender.refresh``; ``serve.top_k``:
  ``Recommender.top_k`` / ``top_k_with_scores`` to the lists on the host;
* ``serve.tile``: each user tile of ``models/base.py``'s feature and
  full-history catalog scorers, and the launches of DIN's full-history
  kernel (``ops/din_full_history.py``); ``serve.buckets``: building one
  length bucket's padded histories and lengths and copying them to the
  device, or, on the kernel's route, packing every history as CSR and its
  one non-blocking copy;
* counters ``serve.positions_real`` (each user's history length times the
  items) and ``serve.positions_scored`` (the bucketed scorer: each bucket's
  users times its length times the items padded to whole chunks; the
  kernel: each user's length rounded up to its step of two positions times
  the items rounded up to its tile of 16), of the full-history scorers.

The profiler:

* ``trace(log_dir)``: ``torch.profiler`` over the enclosed block, CPU and, on
  a CUDA machine, the card's kernels, with the recorder on; writes one Chrome
  trace (``trace.json``, for Perfetto or chrome://tracing) and the spans'
  summary (``spans.json``: each span's calls, host and device milliseconds,
  and the counters) into ``log_dir``.
* ``debug_nans(enable)``: autograd's anomaly mode with its NaN check. Unlike
  JAX's ``jax_debug_nans``, which raises at the first primitive whose output
  holds a NaN, forward or backward, anomaly mode checks the backward: it
  raises where a backward function returns a NaN gradient and names the
  forward op that made it (recording each op's traceback, so it is slow).
  A NaN that appears in the forward and never reaches a gradient passes.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# the no-op context every span() returns while nothing records or profiles
_OFF = contextlib.nullcontext()
# the record that spans and counters go to while recording() is on
_active: Optional["Record"] = None


class _Span:
    """One span of a ``Record``; see the module's docstring."""

    __slots__ = ("record", "name", "parent", "start_ns", "end_ns", "events", "_annotation")

    def __init__(self, record: "Record", name: str):
        self.record, self.name = record, name
        self.parent: Optional[str] = None
        self.start_ns = self.end_ns = 0
        self.events = None
        self._annotation = None

    def __enter__(self) -> "_Span":
        stack = self.record._stack
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = time.time_ns()
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._annotation.__exit__(*exc)
        self._annotation = None
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        self.record._stack.pop()
        self.record.spans.append(self)
        return False

    def device_ms(self) -> Optional[float]:
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


class Record:
    """The spans (in the order they ended) and counters of one recording."""

    def __init__(self):
        self.spans: List[_Span] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self._stack: List[_Span] = []

    def export(self) -> Dict:
        """``{"spans": [{name, parent, start_ns, end_ns, device_ms}],
        "counters": {name: n}}``; ``device_ms`` is None without CUDA. Reads
        the spans' timing events, so it waits for the device to reach the
        last span's end."""
        return {"spans": [{"name": s.name, "parent": s.parent, "start_ns": s.start_ns,
                           "end_ns": s.end_ns, "device_ms": s.device_ms()} for s in self.spans],
                "counters": dict(self.counters)}

    def summary(self) -> Dict:
        """``{"spans": {name: {calls, host_ms, device_ms}}, "counters"}``:
        each span name's calls and summed milliseconds (``device_ms`` None
        without CUDA)."""
        out: Dict[str, Dict] = {}
        for s in self.export()["spans"]:
            row = out.setdefault(s["name"], {"calls": 0, "host_ms": 0.0, "device_ms": None})
            row["calls"] += 1
            row["host_ms"] += (s["end_ns"] - s["start_ns"]) / 1e6
            if s["device_ms"] is not None:
                row["device_ms"] = (row["device_ms"] or 0.0) + s["device_ms"]
        return {"spans": out, "counters": dict(self.counters)}


def span(name: str):
    """A span named ``name`` around the enclosed block (see the module's
    docstring); the shared no-op where nothing records or profiles."""
    record = _active
    if record is not None:
        return _Span(record, name)
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` while recording."""
    record = _active
    if record is not None:
        record.counters[name] += n


def is_recording() -> bool:
    """Whether spans and counters are being recorded."""
    return _active is not None


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Records the spans and counters of the enclosed block into the
    ``Record`` it yields; one recording at a time, from one thread."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already on")
    _active = record = Record()
    try:
        yield record
    finally:
        _active = None


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace of the enclosed block into
    ``log_dir/trace.json``, and its spans' summary into ``log_dir/spans.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with recording() as record:
            yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w", encoding="utf-8") as f:
        json.dump(record.summary(), f, indent=1, sort_keys=True)


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Autograd's anomaly mode with its NaN check for the enclosed block."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)
