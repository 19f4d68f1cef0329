"""The ``sparse_train`` kind and DLRM-DCNv2's pieces on the CPU: the
``dlrm-dcnv2-train`` cell rehearsed at the mix's ``cpu`` size (every width
as published), its faults and the TF32 control against its limits, a fault
in the program's ids, the costs against hand counts and the reference's
products, the cut's arithmetic, and the new readers on synthetic records."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import contract, harness, refcommon, spec, weights
from portbench.costs import dlrm as costs
from portbench.program import replaced

CELL = "dlrm-dcnv2-train"
BENCH = spec.benchmark()
CONFIG = spec.config("dlrm-dcnv2-criteo1tb")
KIND = spec.kind("sparse_train")
SEED = 2**31 + 17
CPU = torch.device("cpu")


def run(capsys, trace=0):
    rc = harness.main(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.2",
                       "--trace", str(trace)], device=CPU)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out and out[-1].startswith("{") else None)


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(capsys, trace):
    rc, line = run(capsys, trace)
    assert rc == 0 and contract.problems(line, BENCH, CELL, bool(trace)) == []
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert line["checks"]["feed_mismatch"]["value"] == 0
    if trace:  # the counters read on the CPU; the spans' device time needs the card
        assert 0 < line["metrics"]["rows_unique.train"]["value"] <= 100
    else:
        assert set(line["metrics"]) == {"setup_s", "train_rows_per_s"}


@pytest.mark.parametrize("fault", sorted(KIND.FAULTS))
def test_a_fault_under_the_timed_path_is_not_correct(capsys, fault):
    with KIND.FAULTS[fault]():
        rc, line = run(capsys)
    assert rc == 0 and line["correct"] is False


def test_ids_sliced_wrong_are_not_correct(capsys):
    """A fault in what the program derives from the batch: every table's ids
    are the next row's."""
    from deeplearningrecommendationsystem_tpu_torch.models import dlrm

    def shifted(orig):
        def table_ids(self, batch):
            return orig(self, {"ids": torch.roll(batch["ids"], 1, dims=0)})
        return table_ids

    with replaced(dlrm.DLRM, "table_ids", shifted):
        rc, line = run(capsys)
    assert rc == 0 and line["correct"] is False and line["checks"]["feed_mismatch"]["value"] > 0


def test_the_control_fails_a_limit():
    w = spec.workload(BENCH, CELL)
    env = SimpleNamespace(config=CONFIG, traffic=spec.traffic(w["traffic"]), seed=SEED,
                          device=CPU, workload=w)
    c = KIND.Cell(env)
    c.unit(None)
    c.release()
    limits = spec.limits(CELL)
    sound = c.numbers()
    assert all(v <= limits[k] for k, v in sound.items()), sound
    control = c.control()
    assert any(v > limits[k] for k, v in control.items()), control


def test_products_by_hand():
    assert costs.row_products(CONFIG) == 32_060_928
    # the cross, 3 layers of 2 x 2 d r at d 3,456 and r 512: 21,233,664, 66% of the forward
    assert costs.row_products(dict(CONFIG, dcn_num_layers=0)) == 32_060_928 - 21_233_664
    assert costs.train_row_products(CONFIG) == 96_169_472
    assert 8192 * costs.train_row_products(CONFIG) == pytest.approx(787.8e9, rel=1e-4)


def test_the_cut():
    ref = spec.reference("dlrm")
    held = ref.heights(CONFIG)
    assert sum(held) == 26_500_127 and sum(CONFIG["num_embeddings_per_feature"]) == 204_184_588
    assert sum(held) * CONFIG["embedding_dim"] * 4 == pytest.approx(13.57e9, rel=1e-3)
    for f, v in enumerate(CONFIG["num_embeddings_per_feature"]):
        sliced = f"cat_{f}" in CONFIG["reduced"]
        assert sliced == (v > 1_000_000)
        assert held[f] == (-(-v // 8) if sliced else v)
    assert sum(CONFIG["multi_hot_sizes"]) == 214


SMALL = dict(CONFIG, num_embeddings_per_feature=[7] * 26, embedding_dim=8,
             dense_arch_layer_sizes=[16, 8], over_arch_layer_sizes=[12, 6, 1], dcn_low_rank_dim=4,
             **{f"cat_{f}": 7 for f in range(26)})


def test_costs_equal_the_reference_products():
    ref = spec.reference("dlrm")
    p = weights.draw(ref.dense_specs(SMALL), 0, CPU)
    p.update({f"tables.{f}": torch.rand(7, 8) for f in range(26)})
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    batch = {"dense": torch.rand(5, 13), "ids": torch.randint(0, 7, (5, 214))}
    counter = FlopCounterMode(display=False)
    with counter, refcommon.precision("float32", CPU) as mm:
        ref.train_loss(mm, SMALL, leaves, batch, torch.ones(5)).backward()
    assert counter.get_total_flops() == 5 * costs.train_row_products(SMALL)


def test_the_lookup_bound_counts_each_gather():
    out = costs.train_unit(SMALL, 10, [[(20, 3), (10, 10)], [(20, 5)]])
    D = 8
    want = sum(20 * D * 4 + 20 * 8 + t * D * 4 for t in (3, 5)) + 10 * D * 4 + 10 * 8 + 10 * D * 4
    assert out["bounds"]["lookup"] == pytest.approx(want / 3.35e12)
    assert out["products"] == 10 * costs.train_row_products(SMALL)


def _unit(traced, spans, work):
    return {"seconds": 1.0, "traced": traced, "spans": spans, "work": work}


RECORD = {"units": [
    _unit(True, {}, {"rows": 8}),
    _unit(False, {"train.lookup": 0.002, "dlrm.bags": 0.001, "dlrm.cross": 0.004,
                  "train.sparse_update": 0.003}, {"rows": 8, "ids": 10, "rows_touched": 4}),
    _unit(False, {"train.lookup": 0.004, "dlrm.bags": 0.001, "dlrm.cross": 0.006,
                  "train.sparse_update": 0.005}, {"rows": 8, "ids": 10, "rows_touched": 6}),
    _unit(False, {"train.lookup": 0.003, "dlrm.bags": 0.002, "dlrm.cross": 0.005,
                  "train.sparse_update": 0.001}, {"rows": 8, "ids": 20, "rows_touched": 2}),
]}
READINGS = [("bags_ms.train", 5.0), ("cross_ms.train", 5.0), ("row_update_ms.train", 3.0),
            ("rows_unique.train", 100.0 * 12 / 40)]


@pytest.mark.parametrize("name,want", READINGS, ids=[r[0] for r in READINGS])
def test_each_new_reader_on_a_synthetic_record(name, want):
    read = spec.metric(name).read
    assert read(RECORD) == pytest.approx(want)
    # a record without the program's spans or counters (an untraced run, the parent)
    assert read({"units": [_unit(False, {}, {"rows": 8})]}) is None
