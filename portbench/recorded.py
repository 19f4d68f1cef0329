#!/usr/bin/env python3
"""The program's own spans and counters over a cell's units.

The port records spans and counters inside itself while a caller turns its
recorder on (``runtime/profiler.py::recording``): the training step's
forward, backward and optimizer, the refresh, the full-history scorer's
buckets and tiles, and that scorer's counts of real and scored positions.
This module runs a cell's units with the recorder on and reads them:

    python3 portbench/recorded.py --workload din-refresh --seed 2147483901 --seconds 15

One run: the cell's set-up and a window of timed units with the recorder
off, as a ``--trace 0`` run of ``run.py`` makes them (``harness.window``);
then the mix's ``trace_units`` units under ``torch.profiler`` with the
recorder on, whose trace (``trace.py``) names each idle gap of the device by
the innermost host event at its middle, the program's spans among them; then
``trace_units`` more units with the recorder on and no profiler, the
``program`` record. There is no check: the outputs are not compared, the
spans are read. It prints one JSON line: the five readings below, what
recording costs a unit (the recorded units' median seconds over the timed
units' median, less 1), the training cells' coverage (the step's three spans
over ``train.epoch``, and ``train.epoch`` over the profiled units' busy
device time), each span's calls, host and device milliseconds a unit, and
the profiled units' idle gaps by name.

The ``program`` record, a list with one entry a recorded unit:
``{"seconds", "spans": [{name, parent, start_ns, end_ns, device_ms}],
"counters": {name: n}}``, the recorder's export. Its readers, one file each
under ``metrics/``:

* ``forward_ms.train``, ``backward_ms.train``, ``optimizer_ms.train``: the
  median device milliseconds of ``train.forward``, ``train.backward`` and
  ``train.optimizer`` over every epoch of the recorded units;
* ``buckets_host_ms.refresh``: the host milliseconds of every
  ``serve.buckets`` of a refresh, the median over the recorded refreshes;
* ``history_useful.refresh``: ``serve.positions_real`` over
  ``serve.positions_scored``, in percent.

Each returns None where the record has nothing to read: no ``program`` key,
no such span or counter, or no device time (a CPU run).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from deeplearningrecommendationsystem_tpu_torch.runtime import profiler  # noqa: E402

from portbench import spec, trace  # noqa: E402
from portbench.program import synchronize  # noqa: E402

STEP = ("train.forward", "train.backward", "train.optimizer")


def _spans(rec: Dict, name: str) -> List[List[Dict]]:
    """The spans ``name`` of each recorded unit."""
    return [[s for s in u["spans"] if s["name"] == name] for u in rec.get("program") or []]


def span_device_ms(rec: Dict, name: str) -> Optional[float]:
    """The median device milliseconds of every span ``name`` of the recorded
    units; None without such a span or without device time."""
    ms = [s["device_ms"] for unit in _spans(rec, name) for s in unit]
    if not ms or any(m is None for m in ms):
        return None
    return statistics.median(ms)


def unit_host_ms(rec: Dict, name: str) -> Optional[float]:
    """The host milliseconds of every span ``name`` of a recorded unit,
    summed, the median over the units that have it."""
    sums = [sum(s["end_ns"] - s["start_ns"] for s in unit) / 1e6
            for unit in _spans(rec, name) if unit]
    return statistics.median(sums) if sums else None


def counter_share(rec: Dict, part: str, whole: str) -> Optional[float]:
    """All the recorded units' counter ``part`` over their ``whole``, in percent."""
    units = rec.get("program") or []
    num = sum(u["counters"].get(part, 0) for u in units)
    den = sum(u["counters"].get(whole, 0) for u in units)
    return 100.0 * num / den if den else None


def _unit_sum(unit: Dict, name: str, key: str) -> Optional[float]:
    vals = [(s["end_ns"] - s["start_ns"]) / 1e6 if key == "host_ms" else s["device_ms"]
            for s in unit["spans"] if s["name"] == name]
    return None if any(v is None for v in vals) else sum(vals)


def span_table(rec: Dict) -> Dict[str, Dict]:
    """Each span name: its calls a unit, and its summed host and device
    milliseconds a unit (the medians over the recorded units)."""
    units = rec.get("program") or []
    names = sorted({s["name"] for u in units for s in u["spans"]})
    out = {}
    for name in names:
        row = {"calls": statistics.median([sum(s["name"] == name for s in u["spans"])
                                           for u in units])}
        for key in ("host_ms", "device_ms"):
            vals = [_unit_sum(u, name, key) for u in units]
            row[key] = None if None in vals else statistics.median(vals)
        out[name] = row
    return out


def coverage(rec: Dict) -> Optional[Dict[str, float]]:
    """The training cells' coverage: the step's three spans' device
    milliseconds over ``train.epoch``'s, and ``train.epoch``'s a unit over
    the profiled units' busy device seconds a unit (each 1 where the spans
    cover all of it)."""
    table = span_table(rec)
    epoch = table.get("train.epoch", {}).get("device_ms")
    if not epoch or any(table.get(n, {}).get("device_ms") is None for n in STEP):
        return None
    out = {"steps_over_epoch": sum(table[n]["device_ms"] for n in STEP) / epoch}
    tr = rec.get("trace")
    if tr and tr["busy_s"] > 0:
        out["epochs_over_busy"] = epoch / 1e3 / (tr["busy_s"] / rec["traced_units"])
    return out


def named_idle(rec: Dict) -> Optional[Dict[str, float]]:
    """The profiled units' idle seconds: in all, and of the ten names with
    the most, those named by one of the program's spans and those named by
    no host operation."""
    tr = rec.get("trace")
    if not tr:
        return None
    program = {s["name"] for u in rec.get("program") or [] for s in u["spans"]}
    gaps = tr["idle_gaps"]
    return {"idle_s": tr["window_s"] - tr["busy_s"],
            "program_span_s": sum(s for name, s in gaps if name in program),
            "no_host_operation_s": sum(s for name, s in gaps if name == "no host operation")}


def program_units(cell, n: int, device: torch.device) -> List[Dict]:
    """``n`` units with the recorder on, each ``{"seconds", "spans",
    "counters"}``; the export, which reads the timing events, after the
    unit's clock has stopped."""
    out = []
    for _ in range(n):
        with profiler.recording() as record:
            t0 = time.perf_counter()
            cell.unit(None)
            synchronize(device)
            seconds = time.perf_counter() - t0
        out.append({"seconds": seconds, **record.export()})
    return out


def profiled_units(cell, n: int, device: torch.device) -> Dict:
    """``n`` units under ``torch.profiler`` with the recorder on; their trace,
    reduced by ``trace.summarize``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with profiler.recording():
            for _ in range(n):
                cell.unit(None)
            synchronize(device)
    return trace.summarize(trace.events(prof))


METRICS = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
           "buckets_host_ms.refresh", "history_useful.refresh")


def main(argv: Optional[List[str]] = None, device: Optional[torch.device] = None,
         overrides: Optional[Dict] = None) -> int:
    """One run; ``device`` and ``overrides`` as ``harness.main``'s, for the
    CPU tests. Exit 2 without the card(s) the cell asks for."""
    from portbench import harness

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description="A cell's units with the program's recorder on.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    entry = spec.workload(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
            print(f"recorded: {args.workload} needs {entry['chips']} CUDA device(s)",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    overrides = overrides or {}
    env = SimpleNamespace(
        config=spec.merge(spec.config(entry["config"]), overrides.get("config")),
        traffic=spec.merge(spec.traffic(entry["traffic"]), overrides.get("traffic")),
        seed=args.seed, device=device, workload=entry)
    cell = spec.kind(env.traffic["kind"]).Cell(env)
    n = int(env.traffic["trace_units"])
    rec = harness.window(cell, args.seconds, 0, device, t_start)
    rec["kind"], rec["traced_units"] = env.traffic["kind"], n
    rec["trace"] = profiled_units(cell, n, device)
    rec["program"] = program_units(cell, n, device)
    timed = statistics.median(u["seconds"] for u in rec["units"])
    recorded = statistics.median(u["seconds"] for u in rec["program"])
    line = {
        "workload": args.workload, "seed": args.seed,
        "device": harness.device_block(device, int(entry["chips"])),
        "metrics": {m: spec.metric(m).read(rec) for m in METRICS},
        "timed_units": len(rec["units"]), "timed_median_s": timed,
        "recorded_median_s": recorded, "cost_when_on": recorded / timed - 1.0,
        "coverage": coverage(rec), "named_idle": named_idle(rec),
        "busy_s": rec["trace"]["busy_s"], "idle_gaps": rec["trace"]["idle_gaps"],
        "spans": span_table(rec), "counters": rec["program"][-1]["counters"],
    }
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
