"""Reading the profiler's trace of a traced window.

``torch.profiler`` (CPU and CUDA activities) records the host's operations
and the device's (kernels, copies, fills) on one clock. From it:

* the device's busy time: the union of the device operations' intervals,
  so operations that overlap on two streams count once;
* each device operation's summed time, by the name the profiler gives it;
* the idle gaps: the stretches of the window in which no device operation
  ran, each named by the innermost host operation running at its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

Interval = Tuple[int, int]  # nanoseconds on the profiler's clock


def _span(ev) -> Interval:
    """(start, end) in nanoseconds of a kineto event."""
    if hasattr(ev, "start_ns"):
        start = int(ev.start_ns())
        return start, start + int(ev.duration_ns())
    start = int(ev.start_us()) * 1000
    return start, start + int(ev.duration_us()) * 1000


def events(prof) -> Dict[str, List[Tuple[str, int, int]]]:
    """{"device": [(name, start, end)], "host": [...]} of a finished profile,
    in nanoseconds."""
    out = {"device": [], "host": []}
    for ev in prof.profiler.kineto_results.events():
        host = "CPU" in str(ev.device_type())
        # a device-side annotation spans kernels and the gaps between them
        if not host and getattr(ev, "is_user_annotation", lambda: False)():
            continue
        start, end = _span(ev)
        out["host" if host else "device"].append((ev.name(), start, end))
    return out


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals``, as sorted disjoint intervals."""
    merged: List[List[int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of [lo, hi] outside the disjoint sorted ``busy``."""
    out, at = [], lo
    for start, end in busy:
        if start > at:
            out.append((at, min(start, hi)))
        at = max(at, end)
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def innermost(host: Sequence[Tuple[str, int, int]], t: float) -> str:
    """The name of the host operation running at ``t`` that started last."""
    best, best_start = "no host operation", float("-inf")
    for name, start, end in host:
        if start <= t <= end and start > best_start:
            best, best_start = name, start
    return best


def summarize(ev: Dict[str, List[Tuple[str, int, int]]], top: int = 10,
              named_gaps: int = 1000) -> Dict:
    """The traced window's length, the device's busy seconds, each device
    operation's seconds, and the idle seconds of the ``named_gaps`` longest
    gaps by what the host was doing, in seconds."""
    device, host = ev["device"], ev["host"]
    everything = [(s, e) for _, s, e in device] + [(s, e) for _, s, e in host]
    if not everything:
        return {"window_s": 0.0, "busy_s": 0.0, "device_ops": {}, "idle_gaps": []}
    lo = min(s for s, _ in everything)
    hi = max(e for _, e in everything)
    busy = union([(s, e) for _, s, e in device])
    per_op: Dict[str, int] = defaultdict(int)
    for name, s, e in device:
        per_op[name] += e - s
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])
    host_sorted = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host_sorted]
    by_host: Dict[str, int] = defaultdict(int)
    for a, b in idle[:named_gaps]:
        mid = 0.5 * (a + b)
        # operations starting after the middle cannot cover it
        at = bisect.bisect_right(starts, mid)
        by_host[innermost(host_sorted[max(0, at - 2048):at], mid)] += b - a
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "device_ops": {k: v * 1e-9 for k, v in per_op.items()},
        "idle_gaps": [[k, v * 1e-9] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:top]],
    }


def top_ops(device_ops: Dict[str, float], top: int = 10) -> List[List]:
    return [[name, secs] for name, secs in sorted(device_ops.items(), key=lambda kv: -kv[1])[:top]]
