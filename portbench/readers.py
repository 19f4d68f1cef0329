"""What the metric readers share: they read one run's record.

The record of a run (``harness.py``):

* ``setup_s``: the process's start to the first timed unit's start;
* ``window_s``: the window's start to its last unit's end;
* ``units``: each unit of the window, ``{"seconds", "work": {count: n},
  "traced": bool, "spans": {name: seconds}}``; spans are taken only in a
  traced run, around the benchmark's own calls into the program, with a
  synchronise, in the units after the profiled ones;
* ``costs``: the kind's operations and bounds of one unit (``products``, and
  ``bounds``: a kernel family's least seconds a unit);
* ``trace``: the profiled units' trace (``trace.py::summarize``), or None.

A reader returns None where it finds nothing to read; the metric is then
left out of the run's line.
"""

from __future__ import annotations

import math
import re
import statistics
from typing import Dict, List, Optional

from portbench import peaks


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


def percentile(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile: the smallest value with at least
    ``q`` percent of the values at or below it."""
    s = sorted(values)
    if not s:
        return None
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def rate(rec: Dict, count: str) -> Optional[float]:
    """All the window's ``count`` over all the window's time."""
    units = [u for u in rec["units"] if count in u["work"]]
    if not units or rec["window_s"] <= 0:
        return None
    return sum(u["work"][count] for u in units) / rec["window_s"]


def unit_seconds(rec: Dict, count: str) -> List[float]:
    """Each window unit's seconds, of the units that do ``count``."""
    return [u["seconds"] for u in rec["units"] if count in u["work"]]


def _timed(rec: Dict) -> List[Dict]:
    """The units timed without the profiler."""
    return [u for u in rec["units"] if not u["traced"]]


def span_ms(rec: Dict, name: str) -> Optional[float]:
    """The median span ``name`` of the unprofiled units, in milliseconds."""
    m = median([u["spans"][name] for u in _timed(rec) if name in u.get("spans", {})])
    return None if m is None else 1e3 * m


def unit_mfu(rec: Dict, count: str) -> Optional[float]:
    """A unit's products over the median unprofiled unit's seconds, as a
    share of the product peak, in percent."""
    if rec["trace"] is None:
        return None
    m = median([u["seconds"] for u in _timed(rec) if count in u["work"]])
    products = rec["costs"].get("products")
    if m is None or not products:
        return None
    return peaks.mfu_percent(products, m)


def span_mfu(rec: Dict, span: str) -> Optional[float]:
    """A unit's products over its median span ``span``, in percent of the peak."""
    m = span_ms(rec, span)
    products = rec["costs"].get("products")
    if m is None or not products:
        return None
    return peaks.mfu_percent(products, m / 1e3)


def kernel_seconds(rec: Dict, pattern: str) -> Optional[float]:
    """The traced units' summed device seconds of the operations whose names
    match ``pattern``."""
    tr = rec["trace"]
    if tr is None:
        return None
    rx = re.compile(pattern)
    return sum(s for name, s in tr["device_ops"].items() if rx.search(name))


def roofline(rec: Dict, family: str, pattern: str) -> Optional[float]:
    """The family's least seconds over the traced units, over the seconds its
    kernels took there, in percent; None where the family has no bound in
    this cell or no kernel of it ran."""
    bound = rec["costs"].get("bounds", {}).get(family)
    took = kernel_seconds(rec, pattern)
    if not bound or not took:
        return None
    return 100.0 * bound * rec["traced_units"] / took


def idle_share(rec: Dict, kind: str) -> Optional[float]:
    """The share of a unit's time in which no device operation ran, in
    percent; only in cells of the kind ``kind``. The device's busy time a
    unit is the union of its operations' intervals in the profiled units;
    the unit's time is the median unprofiled unit's, since the profiler
    slows the host and not the device."""
    tr = rec["trace"]
    if tr is None or rec["kind"] != kind or tr["busy_s"] <= 0:
        return None
    m = median([u["seconds"] for u in _timed(rec)])
    if m is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / rec["traced_units"] / m)
