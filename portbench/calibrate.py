#!/usr/bin/env python3
"""The readings the limits of a cell's correctness numbers are set from.

    python3 portbench/calibrate.py --workload din-train --seeds 11 12 ... \
        --control-seeds 21 22 23 [--fault-seeds 31 32 33] [--units 2]

For each seed of ``--seeds``, one JSON line of the numbers that a sound run
of the program gives: set-up from the seed, ``--units`` units of the cell's
timed path, and the comparison with the plain reference in float32. For each
of ``--control-seeds``, the numbers of the control: the reference in TF32 put
in the program's place. For each of ``--fault-seeds``, the numbers under each
fault the cell's kind can have (its ``FAULTS``), planted in the program for
set-up and the units. No measured window: these are the readings of the
check alone. Needs the cell's card.
"""

import argparse
import contextlib
import json
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import spec  # noqa: E402


def _cell(entry, config, traffic, seed, device, units, fault):
    env = SimpleNamespace(config=config, traffic=traffic, seed=seed, device=device,
                          workload=entry)
    kind = spec.kind(traffic["kind"])
    with kind.FAULTS[fault]() if fault else contextlib.nullcontext():
        cell = kind.Cell(env)
        for _ in range(units):
            cell.unit(None)
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--units", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    entry = spec.workload(spec.benchmark(), args.workload)
    config = spec.config(entry["config"])
    traffic = spec.traffic(entry["traffic"])
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, None) for s in args.control_seeds]
    runs += [(f, s, f) for s in args.fault_seeds for f in spec.kind(traffic["kind"]).FAULTS]
    for what, seed, fault in runs:
        t0 = time.perf_counter()
        cell = _cell(entry, config, traffic, seed, device, args.units, fault)
        cell.release()
        t1 = time.perf_counter()
        numbers = cell.control() if what == "control" else cell.numbers()
        print(json.dumps({"workload": args.workload, "what": what, "seed": seed,
                          "numbers": numbers, "leaves": getattr(cell, "leaves", None),
                          "unit_gaps": getattr(cell, "unit_gaps", None),
                          "seconds": time.perf_counter() - t0,
                          "check_seconds": time.perf_counter() - t1}), flush=True)
        del cell
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
