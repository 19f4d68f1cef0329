"""The result line's contract, checked before the line is printed."""

from __future__ import annotations

import math
import re
from typing import Dict, List

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool) and math.isfinite(x)


def problems(line: Dict, bench: Dict, workload: str, trace: bool) -> List[str]:
    """What in ``line`` breaks the contract; empty where nothing does."""
    out = []
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += (["breakdown"] if trace else []) + ["checks"]
    if list(line) != keys:
        out.append(f"keys {list(line)}, not {keys}")
        return out
    if not isinstance(line["correct"], bool):
        out.append("correct is not a bool")
    for k in ("attempted", "failed"):
        if not isinstance(line[k], int) or line[k] < 0:
            out.append(f"{k} is not a count")
    allowed = {m["name"]: m["unit"] for m in spec.cell_metrics(bench, workload, trace)}
    for name, m in line["metrics"].items():
        if name not in allowed:
            out.append(f"metric {name} is not one of the cell's")
        elif set(m) != {"value", "unit"} or m["unit"] != allowed[name]:
            out.append(f"metric {name}: {m}")
        elif not _number(m["value"]):
            out.append(f"metric {name} is not a finite number")
        if not NAME.match(name) or not UNIT.match(m.get("unit", "")):
            out.append(f"metric {name}: a name or unit outside the allowed characters")
    dev = line["device"]
    need = DEVICE_KEYS | ({"busy_s", "window_s"} if trace else set())
    if not need <= set(dev):
        out.append(f"device lacks {sorted(need - set(dev))}")
    if trace:
        bd = line["breakdown"]
        if set(bd) != {"device_ops", "idle_gaps"}:
            out.append(f"breakdown keys {sorted(bd)}")
        for key, entries in bd.items():
            if len(entries) > 10 or not all(
                    isinstance(e, list) and len(e) == 2 and isinstance(e[0], str) and _number(e[1])
                    for e in entries):
                out.append(f"breakdown {key} is not at most 10 [name, seconds]")
    for name, c in line["checks"].items():
        if set(c) != {"value", "limit"} or not (_number(c["value"]) and _number(c["limit"])):
            out.append(f"check {name}: {c}")
    return out
