"""The trace's reduction: busy time as the union of device intervals, the
idle gaps named by the host's innermost operation, and the readers on it."""

from __future__ import annotations

import pytest

from portbench import readers, trace

# two kernels overlapping on two streams (0-10 and 5-15), one alone (20-30);
# the host runs "outer" over the whole window and "sync" from 16 to 19
EVENTS = {
    "device": [("k1", 0, 10), ("k2", 5, 15), ("k3", 20, 30)],
    "host": [("outer", 0, 40), ("sync", 16, 19)],
}


def test_union_counts_overlap_once():
    busy = trace.union([(s, e) for _, s, e in EVENTS["device"]])
    assert busy == [(0, 15), (20, 30)]
    assert trace.gaps(busy, 0, 40) == [(15, 20), (30, 40)]


def test_summary_of_an_overlap():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(40e-9)
    assert s["busy_s"] == pytest.approx(25e-9)  # the summed kernel times would say 30
    assert sum(s["device_ops"].values()) == pytest.approx(30e-9)
    # the gap 15-20 is named by "sync" (inside "outer", started later); 30-40 by "outer"
    assert dict(s["idle_gaps"]) == pytest.approx({"outer": 10e-9, "sync": 5e-9})
    # one profiled unit busy 25 ns; the unprofiled units took 40 ns
    rec = {"trace": s, "kind": "train", "traced_units": 1,
           "units": [{"seconds": 80e-9, "traced": True}, {"seconds": 40e-9, "traced": False}]}
    assert readers.idle_share(rec, "train") == pytest.approx(37.5)
    assert readers.idle_share(rec, "refresh") is None


def test_a_gap_outside_every_host_operation():
    s = trace.summarize({"device": [("k", 10, 20)], "host": [("h", 0, 3)]})
    assert dict(s["idle_gaps"]) == pytest.approx({"no host operation": 10e-9})


def test_no_device_operation_reads_nothing():
    s = trace.summarize({"device": [], "host": [("h", 0, 5)]})
    assert s["busy_s"] == 0.0
    assert readers.idle_share({"trace": s, "kind": "train", "traced_units": 1,
                               "units": [{"seconds": 1.0, "traced": False}]}, "train") is None


def test_readers_of_a_record():
    units = [{"seconds": 2.0, "work": {"rows": 10}, "traced": True, "spans": {}},
             {"seconds": 1.0, "work": {"rows": 10}, "traced": False, "spans": {"refresh": 0.5}},
             {"seconds": 3.0, "work": {"rows": 10}, "traced": False, "spans": {"refresh": 0.25}}]
    rec = {"units": units, "window_s": 6.0, "trace": {"device_ops": {"void din_x_kernel<1>": 2.0,
                                                                     "other": 1.0}},
           "traced_units": 1, "costs": {"products": 495e12, "bounds": {"din_head": 0.5}}}
    assert readers.rate(rec, "rows") == 5.0
    assert readers.rate(rec, "lists") is None
    assert readers.span_ms(rec, "refresh") == pytest.approx(375.0)
    assert readers.unit_mfu(rec, "rows") == pytest.approx(50.0)  # 1 s of peak work in 2 s
    assert readers.roofline(rec, "din_head", r"\bdin_\w*kernel") == pytest.approx(25.0)
    assert readers.roofline(rec, "lookup", "gather") is None
    assert readers.percentile([5, 1, 4, 2, 3], 95) == 5
    assert readers.percentile(list(range(1, 101)), 95) == 95
