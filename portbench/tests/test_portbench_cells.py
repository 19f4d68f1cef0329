"""Each cell rehearsed on the CPU at a tiny size: a whole run through the
harness (its look for a card skipped), the result line held to the
contract; the check's verdict with a fault planted under the timed path and
with the control in the program's place; and the ways a run refuses to
print a result."""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import contract, harness, spec
from portbench.program import replaced

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {"config": {"fixture": {"num_users": 60, "num_items": 300, "num_ratings": 3000},
                   "epochs": 4}}
SEED = 2**31 + 17  # larger than 32 signed bits hold
CPU = torch.device("cpu")


def run(capsys, cell, trace=0, seed=SEED):
    rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.2",
                       "--trace", str(trace)], device=CPU, overrides=TINY)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out and out[-1].startswith("{") else None)


def kind_of(cell):
    return spec.traffic(spec.workload(BENCH, cell)["traffic"])["kind"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(capsys, cell, trace):
    rc, line = run(capsys, cell, trace)
    assert rc == 0 and line is not None
    assert contract.problems(line, BENCH, cell, bool(trace)) == []
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(spec.limits(cell))
    if not trace:  # every end-to-end metric reads on the CPU; per-layer ones need the card's trace
        assert set(line["metrics"]) == {m["name"] for m in spec.cell_metrics(BENCH, cell, False)}


FAULT_CASES = [(c, f) for c in CELLS for f in spec.kind(kind_of(c)).FAULTS]


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_fault_under_the_timed_path_is_not_correct(capsys, cell, fault):
    with spec.kind(kind_of(cell)).FAULTS[fault]():
        rc, line = run(capsys, cell)
    assert rc == 0 and line["correct"] is False


def users_shifted():
    """A fault in what the program derives from the data: every per-user
    input (feature rows, history windows, complete histories) is the next
    user's."""
    from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K

    def shifted(orig):
        def method(self, *args, **kwargs):
            return np.roll(orig(self, *args, **kwargs), 1, axis=0)
        return method

    def init(orig):
        def method(self, *args, **kwargs):
            orig(self, *args, **kwargs)
            self.user_features = np.roll(self.user_features, 1, axis=0)
        return method

    stack = contextlib.ExitStack()
    stack.enter_context(replaced(MovieLens100K, "__init__", init))
    for name in ("history_matrix", "itemid_matrix"):
        stack.enter_context(replaced(MovieLens100K, name, shifted))
    return stack


@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_program_s_inputs_is_not_correct(capsys, cell):
    with users_shifted():
        rc, line = run(capsys, cell)
    assert rc == 0 and line["correct"] is False and line["checks"]["feed_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(cell):
    """The reference in TF32 (on the CPU, its operands rounded to TF32) in
    the program's place fails at least one of the cell's limits."""
    w = spec.workload(BENCH, cell)
    traffic = spec.traffic(w["traffic"])
    env = SimpleNamespace(config=spec.merge(spec.config(w["config"]), TINY["config"]),
                          traffic=traffic, seed=SEED, device=CPU, workload=w)
    c = spec.kind(traffic["kind"]).Cell(env)
    c.unit(None)
    c.release()
    limits = spec.limits(cell)
    sound = c.numbers()
    assert all(v <= limits[k] for k, v in sound.items()), sound
    control = c.control()
    assert any(v > limits[k] for k, v in control.items()), control


def test_same_seed_same_inputs():
    from portbench.program import Setup

    config = spec.merge(spec.config("deepfm-ml100k"), TINY["config"])
    a, b, c = Setup(config, SEED, CPU), Setup(config, SEED, CPU), Setup(config, SEED + 1, CPU)
    assert all(torch.equal(a.weights[k], b.weights[k]) for k in a.weights)
    assert not torch.equal(a.weights["deep_in.w"], c.weights["deep_in.w"])
    assert (a.data.train["item"] == b.data.train["item"]).all()


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_jax_loaded_no_result(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, line = run(capsys, "deepfm-refresh")
    assert rc == 3 and line is None


def test_a_bare_directory_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = BENCH["command"] + ["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                              "--trace", "0"]
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not any(x.startswith("{") for x in p.stdout.splitlines())
