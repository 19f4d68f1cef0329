"""The readers of the program's own spans and counters (``recorded.py``) on
synthetic records; a CPU rehearsal of ``recorded.py`` in every cell; and a
``--trace 0`` run of ``run.py``, whose record has no ``program`` key and
whose line keeps its keys."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import harness, recorded, spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY = {"config": {"fixture": {"num_users": 60, "num_items": 300, "num_ratings": 3000},
                   "epochs": 4}}
SEED = 2**31 + 17
CPU = torch.device("cpu")


def _span(name, ms, device_ms, parent=None, start=0):
    return {"name": name, "parent": parent, "start_ns": start,
            "end_ns": start + int(ms * 1e6), "device_ms": device_ms}


def _train_unit(fwd, bwd, opt):
    spans = []
    for e in range(len(fwd)):
        spans += [_span("train.forward", 0.1, fwd[e], "train.epoch"),
                  _span("train.backward", 0.1, bwd[e], "train.epoch"),
                  _span("train.optimizer", 0.1, opt[e], "train.epoch"),
                  _span("train.epoch", 0.5, fwd[e] + bwd[e] + opt[e], "train.fit")]
    return {"seconds": 1.0, "spans": spans + [_span("train.fit", 2.0, 9.0)], "counters": {}}


def _refresh_unit(bucket_ms, real, scored):
    spans = [_span("serve.buckets", ms, 0.01, "serve.refresh") for ms in bucket_ms]
    return {"seconds": 0.8, "spans": spans + [_span("serve.refresh", 800.0, 790.0)],
            "counters": {"serve.positions_real": real, "serve.positions_scored": scored}}


TRAIN = {"program": [_train_unit([1.0, 1.2, 1.1], [6.0, 6.4, 6.2], [0.1, 0.3, 0.2])]}
REFRESH = {"program": [_refresh_unit([2.0, 3.0], 2, 3), _refresh_unit([4.0, 5.0], 4, 6),
                       _refresh_unit([1.0, 1.0], 2, 3)]}
READINGS = [
    ("forward_ms.train", TRAIN, 1.1),
    ("backward_ms.train", TRAIN, 6.2),
    ("optimizer_ms.train", TRAIN, 0.2),
    ("buckets_host_ms.refresh", REFRESH, 5.0),  # the refreshes' sums 5, 9 and 2
    ("history_useful.refresh", REFRESH, 100.0 * 8 / 12),
]


@pytest.mark.parametrize("name,rec,want", READINGS, ids=[r[0] for r in READINGS])
def test_each_reader_on_a_synthetic_record(name, rec, want):
    read = spec.metric(name).read
    assert read(rec) == pytest.approx(want)
    assert read({"units": []}) is None  # a record without the program's
    other = REFRESH if rec is TRAIN else TRAIN
    assert read(other) is None  # another kind's record: nothing to read


def test_a_cpu_record_has_no_device_time_to_read():
    unit = {"seconds": 1.0, "counters": {},
            "spans": [dict(s, device_ms=None) for s in TRAIN["program"][0]["spans"]]}
    assert spec.metric("forward_ms.train").read({"program": [unit]}) is None


def test_coverage_and_the_span_table():
    table = recorded.span_table(TRAIN)
    assert table["train.epoch"]["calls"] == 3 and table["train.fit"]["calls"] == 1
    # the three epochs' device time: 7.1 + 7.9 + 7.5 ms
    rec = dict(TRAIN, trace={"busy_s": 0.0225, "window_s": 0.03, "idle_gaps": []},
               traced_units=1)
    cov = recorded.coverage(rec)
    assert cov["steps_over_epoch"] == pytest.approx(1.0)
    assert cov["epochs_over_busy"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_on_the_cpu(capsys, cell):
    rc = recorded.main(["--workload", cell, "--seed", str(SEED), "--seconds", "0.2"],
                       device=CPU, overrides=TINY)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    kind = spec.traffic(spec.workload(BENCH, cell)["traffic"])["kind"]
    metrics = line["metrics"]
    # no device time on the CPU: the training spans' device readings are None
    assert metrics["forward_ms.train"] is None and metrics["backward_ms.train"] is None
    if kind == "train":
        assert {"train.fit", "train.epoch", *recorded.STEP} <= set(line["spans"])
        assert line["spans"]["train.forward"]["calls"] == TINY["config"]["epochs"]
    else:
        assert {"serve.refresh", "serve.tile", "serve.top_k"} <= set(line["spans"])
    if cell == "din-refresh":
        assert metrics["buckets_host_ms.refresh"] > 0
        assert 0 < metrics["history_useful.refresh"] < 100
    else:
        assert metrics["buckets_host_ms.refresh"] is None
        assert metrics["history_useful.refresh"] is None


def test_a_trace_0_run_has_no_program_record_and_keeps_its_line(capsys, monkeypatch):
    records = []
    window = harness.window

    def keep(*args, **kwargs):
        records.append(window(*args, **kwargs))
        return records[-1]

    monkeypatch.setattr(harness, "window", keep)
    rc = harness.main(["--workload", "din-refresh", "--seed", str(SEED), "--seconds", "0.2",
                       "--trace", "0"], device=CPU, overrides=TINY)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and "program" not in records[0]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["metrics"]) == {"setup_s", "lists_per_s"}
