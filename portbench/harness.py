"""One run of one cell of the benchmark.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

In order: set-up (the cell's kind of traffic builds everything from the seed
and warms up every shape the window runs); the window (units of work back
to back until ``--seconds`` have passed, the one in flight finished); the
check (the program's state freed, the plain reference run, each number
compared with its limit); then one JSON line, the last of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared with
its limit. The same numbers are the last lines of standard error.

With ``--trace 1`` the first units of the window (the mix's
``trace_units``) run under ``torch.profiler``, and the units after them are
timed with spans around the benchmark's calls into the program.

Exit codes: 0 with a result line; 2 without a card, or with fewer cards than
the cell asks for; 3 if JAX or the JAX package was loaded; 1 on any other
failure. None of these prints a result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from portbench import contract, spec, trace
from portbench.program import synchronize

# modules the run may not hold once the window has closed, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "deeplearningrecommendationsystem_tpu")
# units timed without the profiler that a traced run takes at least
TIMED_UNITS_TRACED = 3


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def window(cell, seconds: float, trace_units: int, device: torch.device, t_start: float) -> Dict:
    """Run the window; returns the run's record (see ``readers.py``)."""
    synchronize(device)
    t_window = time.perf_counter()
    units, profiled, prof = [], None, None
    if trace_units:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    while True:
        traced = prof is not None
        spans = {} if trace_units and not traced else None
        t0 = time.perf_counter()
        work = cell.unit(spans)
        t1 = time.perf_counter()
        units.append({"seconds": t1 - t0, "end": t1 - t_window, "work": work, "traced": traced,
                      "spans": spans or {}})
        if traced and len(units) == trace_units:
            synchronize(device)
            prof.stop()
            profiled, prof = prof, None
        timed = sum(not u["traced"] for u in units)
        if (t1 - t_window >= seconds and prof is None
                and (not trace_units or timed >= TIMED_UNITS_TRACED)):
            break
    return {"setup_s": t_window - t_start, "window_s": units[-1]["end"], "units": units,
            "traced_units": trace_units, "trace": profiled}


def power_limit() -> Optional[str]:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def device_block(device: torch.device, chips: int) -> Dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
           "memory_peak_bytes": int(peak)}
    limit = power_limit()
    if limit:
        out["nvidia_smi"] = limit
    return out


def _finite(x: float) -> float:
    """JSON has no infinity: the largest float stands for it."""
    if math.isnan(x):
        return sys.float_info.max
    return max(-sys.float_info.max, min(sys.float_info.max, x))


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None,
         device: Optional[torch.device] = None, overrides: Optional[Dict] = None) -> int:
    """One run. ``device`` and ``overrides`` ({"config": {...}, "traffic":
    {...}}) are for the benchmark's own tests on the CPU; the command gives
    neither and needs a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    import deeplearningrecommendationsystem_tpu_torch as port

    if not Path(port.__file__).resolve().is_relative_to(spec.ROOT):
        print(f"portbench: the program was imported from {port.__file__}, not from the "
              f"checkout {spec.ROOT}", file=sys.stderr)
        return 1
    bench = spec.benchmark()
    cell_entry = spec.workload(bench, args.workload)
    if device is None:
        chips = int(cell_entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {chips} CUDA device(s), found {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.init()
    overrides = overrides or {}
    env = SimpleNamespace(
        config=spec.merge(spec.config(cell_entry["config"]), overrides.get("config")),
        traffic=spec.merge(spec.traffic(cell_entry["traffic"]), overrides.get("traffic")),
        seed=args.seed, device=device, workload=cell_entry)
    limits = spec.limits(args.workload)
    kind = spec.kind(env.traffic["kind"])
    t_cell = time.perf_counter()
    cell = kind.Cell(env)
    trace_units = int(env.traffic["trace_units"]) if args.trace else 0
    rec = window(cell, args.seconds, trace_units, device, t_start)
    rec["kind"] = env.traffic["kind"]
    rec["costs"] = cell.costs
    dev_block = device_block(device, int(cell_entry["chips"]))
    if rec["trace"] is not None:
        rec["trace"] = trace.summarize(trace.events(rec["trace"]))
        dev_block["busy_s"] = rec["trace"]["busy_s"]
        dev_block["window_s"] = rec["trace"]["window_s"]

    cell.release()
    numbers = cell.numbers()
    checks = {name: {"value": _finite(value), "limit": limits[name]}
              for name, value in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    attempted, failed = cell.attempted_failed(len(rec["units"]), limits)

    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    metrics = {}
    for entry in spec.cell_metrics(bench, args.workload, bool(args.trace)):
        value = spec.metric(entry["name"]).read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_block}
    if rec["trace"] is not None:
        line["breakdown"] = {"device_ops": trace.top_ops(rec["trace"]["device_ops"]),
                             "idle_gaps": rec["trace"]["idle_gaps"]}
    line["checks"] = checks
    bad = contract.problems(line, bench, args.workload, bool(args.trace))
    if bad:
        print("portbench: the result line breaks the contract: " + "; ".join(bad), file=sys.stderr)
        return 1
    phases = {"start": t_cell - t_start, **cell.setup.phases}
    print("setup phases " + json.dumps(phases), file=sys.stderr)
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
