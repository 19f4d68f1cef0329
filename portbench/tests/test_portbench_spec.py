"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds
every piece it names by that name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
               "experts_per_tok", "num_experts_per_tok")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    files = [w for w in cmd if "/" in w]
    assert files and all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in files)
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # 24 cells, 14 runs each and 2 more, fit the 43,200 s that a full check may take
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_their_keys_and_names(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    assert 1 <= len(BENCH["configs"]) <= 24
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((spec.ROOT / c["file"]).read_text())
        assert body == spec.config(c["name"])
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert body["source"] == c["source"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in body
            assert not key.endswith(("_dim", "_rank", "_size")), key
            assert not any(w in key for w in WIDTH_WORDS), key


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in cells)
    assert four <= max(1, len(cells) // 4)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in cells:
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_end_to_end():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16
    names = {m["name"] for m in e2e}
    assert "setup_s" in names
    for m in e2e:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer():
    per = BENCH["per_layer"]
    assert 1 <= len(per) <= 128
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in per:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            # every cell that reports the metric reports what it moves
            assert spec.applies(e2e[m["moves"]], w), (m["name"], w)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in spec.cell_metrics(BENCH, cell, trace=False)]
    per = spec.cell_metrics(BENCH, cell, trace=True)
    assert "setup_s" in e2e and len(e2e) >= 2 and per


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_pieces_found_by_name(cell):
    w = spec.workload(BENCH, cell)
    config = spec.config(w["config"])
    traffic = spec.traffic(w["traffic"])
    kind = spec.kind(traffic["kind"])
    limits = spec.limits(cell)
    assert set(limits) == set(kind.NUMBERS)
    # a positive float, or 0 for an exact comparison (a count of mismatches)
    assert all(isinstance(v, float) and v > 0 or isinstance(v, int) and v == 0
               for v in limits.values()), limits
    ref = spec.reference(config["model"])
    assert callable(ref.train_loss) and callable(ref.catalog_scores)
    assert callable(ref.train_batch) and callable(ref.serving_mismatch)
    assert callable(spec.costs(config["model"]).refresh)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.metric(metric).read)
