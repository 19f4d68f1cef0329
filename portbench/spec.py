"""Finds every piece of the benchmark by the name ``BENCHMARK.json`` gives it.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each metric is a reader of its own. The pieces live in files named after
them, so a new cell, configuration, mix or metric is a new file and a new
entry, and no file here changes:

* ``configs/<config>.json``: the model configuration (the preset's name and
  fields, the fixture, the precision it states);
* ``traffic/<traffic>.json``: the traffic mix, parameters only; its ``kind``
  names the module ``kinds/<kind>.py`` that reads them;
* ``metrics/<metric>.py``: ``read(record) -> float | None``;
* ``costs/<model>.py`` and ``reference/<model>.py``: the operations and bytes
  of the configuration's model, and its plain reference;
* ``limits/<workload>.json``: the limits of the cell's correctness numbers.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def _json(kind: str, name: str) -> Dict[str, Any]:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r}: {path} is missing")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _module(kind: str, name: str) -> ModuleType:
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r}: {path} is missing")
    mod_name = f"portbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(name: str) -> Dict[str, Any]:
    return _json("configs", name)


def traffic(name: str) -> Dict[str, Any]:
    return _json("traffic", name)


def limits(workload_name: str) -> Dict[str, float]:
    return _json("limits", workload_name)


def kind(name: str) -> ModuleType:
    return _module("kinds", name)


def metric(name: str) -> ModuleType:
    return _module("metrics", name)


def costs(model: str) -> ModuleType:
    return _module("costs", model)


def reference(model: str) -> ModuleType:
    return _module("reference", model)


def applies(entry: Dict[str, Any], workload_name: str) -> bool:
    """Whether a metric entry is reported in the cell ``workload_name``: every
    cell where it lists none."""
    return "workloads" not in entry or workload_name in entry["workloads"]


def cell_metrics(bench: Dict[str, Any], workload_name: str, trace: bool) -> List[Dict[str, Any]]:
    """The entries a run of the cell reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if applies(m, workload_name)]


def merge(base: Dict[str, Any], extra: Dict[str, Any] | None) -> Dict[str, Any]:
    """``base`` with ``extra``'s entries, nested dicts merged key by key."""
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out
