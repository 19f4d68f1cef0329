"""The port's recorder (``runtime/profiler.py``): spans and counters, off by
default and free when off, on ``torch.profiler``'s clock when on; the spans
of ``Trainer.fit``, of the row-sparse step with DLRM's, and of the
full-history scorer, whose outputs recording
leaves bit for bit as they are; the scorer's counters against a hand count
and on the benchmark's fixture; and ``trace()``'s ``spans.json``."""

import json

import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.experiments import build_model, split_batches
from deeplearningrecommendationsystem_tpu_torch.models import ServingContext
from deeplearningrecommendationsystem_tpu_torch.models.base import catalog_scores_full_history
from deeplearningrecommendationsystem_tpu_torch.runtime import profiler
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.train.minibatch import epoch_order

STEP_SPANS = ("train.forward", "train.backward", "train.optimizer")


def _nested():
    with profiler.span("outer"):
        profiler.count("things", 2)
        with profiler.span("inner"):
            torch.ones(8).sum()
        with profiler.span("inner"):
            profiler.count("things", 3)


def test_off_the_span_is_the_shared_no_op_and_nothing_is_recorded(monkeypatch):
    def called(*args, **kwargs):
        raise AssertionError("the off path called a torch API")

    monkeypatch.setattr(torch.profiler, "record_function", called)
    monkeypatch.setattr(torch.cuda, "Event", called)
    monkeypatch.setattr(torch.cuda, "is_initialized", called)
    assert not profiler.is_recording()
    assert profiler.span("a") is profiler.span("b") is profiler._OFF
    _nested()
    monkeypatch.undo()
    with profiler.recording() as record:
        pass
    assert record.export() == {"spans": [], "counters": {}}


def test_on_spans_nest_with_their_parents_and_counters_sum():
    with profiler.recording() as record:
        assert profiler.is_recording()
        _nested()
    assert not profiler.is_recording()
    out = record.export()
    assert [(s["name"], s["parent"]) for s in out["spans"]] == [
        ("inner", "outer"), ("inner", "outer"), ("outer", None)]
    assert out["counters"] == {"things": 5}
    inner, _, outer = out["spans"]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
    assert all(s["device_ms"] is None for s in out["spans"])  # no CUDA here
    summary = record.summary()["spans"]
    assert summary["inner"]["calls"] == 2 and summary["outer"]["calls"] == 1
    with pytest.raises(RuntimeError):
        with profiler.recording(), profiler.recording():
            pass


def _host_events(prof):
    """name -> start in nanoseconds of each host event of a finished profile."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if "CPU" in str(ev.device_type()):
            start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
            out.setdefault(ev.name(), []).append(int(start))
    return out


def test_each_span_is_a_host_event_of_the_profiler_on_the_same_clock():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiler.recording() as record:
            _nested()
        with profiler.span("unrecorded"):  # recording off, the profiler on
            torch.ones(8).sum()
    events = _host_events(prof)
    for s in record.export()["spans"]:
        assert min(abs(t - s["start_ns"]) for t in events[s["name"]]) < 1_000_000, s["name"]
    assert "unrecorded" in events
    assert [s["name"] for s in record.export()["spans"]].count("unrecorded") == 0


def _fixture(tmp_path, users=60, items=600, ratings=3000):
    path = write_ml100k_format(str(tmp_path), seed=3, num_users=users, num_items=items,
                               num_ratings=ratings)
    return MovieLens100K(path, seed=0)


def _fit(data, recording):
    cfg = PRESETS["deepfm"].replace(epochs=3, seed=0, track_metrics=False)
    model = build_model(cfg, data)
    batches = split_batches(cfg, data, "cpu")
    trainer = Trainer(model, TrainConfig(learning_rate=cfg.learning_rate, epochs=3,
                                         track_metrics=False), device="cpu")
    if not recording:
        return trainer.fit(batches["train"]), None
    with profiler.recording() as record:
        res = trainer.fit(batches["train"])
    return res, record.export()


def test_fit_records_one_step_of_spans_under_each_epoch_and_the_same_bits(tmp_path):
    data = _fixture(tmp_path)
    off, _ = _fit(data, False)
    on, out = _fit(data, True)
    spans = out["spans"]
    assert [s["name"] for s in spans if s["parent"] is None] == ["train.fit"]
    epochs = [s for s in spans if s["name"] == "train.epoch"]
    assert len(epochs) == 3 and all(s["parent"] == "train.fit" for s in epochs)
    for e in epochs:
        inside = [s["name"] for s in spans if e["start_ns"] <= s["start_ns"] <= e["end_ns"]
                  and s["name"] in STEP_SPANS]
        assert inside == list(STEP_SPANS)
    assert all(s["parent"] == "train.epoch" for s in spans if s["name"] in STEP_SPANS)
    assert off.params.keys() == on.params.keys()
    for k in off.params:
        assert torch.equal(off.params[k], on.params[k]), k
    for k in off.history:
        assert torch.equal(off.history[k], on.history[k]), k


def test_refresh_gives_the_same_bits_recording_on_and_off(tmp_path):
    data = _fixture(tmp_path)
    cfg = PRESETS["din"].replace(seed=0)
    ctx = ServingContext(user_features=torch.from_numpy(data.user_features),
                         item_features=torch.from_numpy(data.item_features),
                         history=torch.from_numpy(data.history_matrix(data.data, cfg.hist_len)),
                         full_histories=[row[row >= 0] for row in data.itemid_matrix(data.data)])
    rec = Recommender(build_model(cfg, data), ctx, seen=data.seen_mask(data.train), device="cpu")
    rec.refresh()
    off, lists_off = rec.scores.clone(), rec.top_k(10)
    with profiler.recording() as record:
        rec.refresh()
        lists_on = rec.top_k(10)
    assert torch.equal(off, rec.scores) and np.array_equal(lists_off, lists_on)
    names = [s["name"] for s in record.export()["spans"]]
    assert names.count("serve.refresh") == 1 and names.count("serve.top_k") == 1
    assert names.count("serve.buckets") >= 1 and names.count("serve.tile") >= 1


def _zeros(params, batch):
    return torch.zeros(batch[0].shape[0])


def test_full_history_counters_match_a_hand_count():
    histories = [np.arange(n) % 300 for n in (3, 40, 70)]
    with profiler.recording() as record:
        catalog_scores_full_history(_zeros, None, histories, 300, "cpu")
    out = record.export()
    # buckets 32, 64 and 128 (the longest history's); 300 items in 2 chunks of 256
    assert out["counters"] == {"serve.positions_real": (3 + 40 + 70) * 300,
                               "serve.positions_scored": (32 + 64 + 128) * 512}
    names = [s["name"] for s in out["spans"]]
    assert names == ["serve.buckets", "serve.tile"] * 3


def test_full_history_useful_share_on_the_benchmark_fixture(tmp_path):
    """The ml-100k-shaped fixture at fixture seed 0, every rating in the
    histories, as the benchmark's refresh cells serve it."""
    path = write_ml100k_format(str(tmp_path), seed=0, num_users=943, num_items=1682,
                               num_ratings=100_000)
    data = MovieLens100K(path, seed=0)
    histories = [row[row >= 0] for row in data.itemid_matrix(data.data)]
    with profiler.recording() as record:
        catalog_scores_full_history(_zeros, None, histories, 1682, "cpu")
    c = record.export()["counters"]
    assert round(100 * c["serve.positions_real"] / c["serve.positions_scored"], 1) == 66.5
    names = [s["name"] for s in record.export()["spans"]]
    assert names.count("serve.buckets") == 7 and names.count("serve.tile") == 71


def test_trace_writes_the_spans_summary_beside_the_trace(tmp_path):
    with profiler.trace(str(tmp_path)):
        _nested()
    assert (tmp_path / "trace.json").is_file()
    summary = json.loads((tmp_path / "spans.json").read_text())
    assert summary["counters"] == {"things": 5}
    assert summary["spans"]["inner"]["calls"] == 2
    assert summary["spans"]["outer"]["host_ms"] >= summary["spans"]["inner"]["host_ms"]
    assert not profiler.is_recording()


def _sparse_dlrm_fit(record_on: bool):
    """Two row-sparse steps of a small DLRM (three bags of 2, 1 and 3 ids)."""
    from deeplearningrecommendationsystem_tpu_torch.models.dlrm import DLRM, BagSpec
    from deeplearningrecommendationsystem_tpu_torch.train.sparse_trainer import (
        fit_minibatch_sparse,
    )

    spec = BagSpec((5, 7, 3), (2, 1, 3))
    net = DLRM(spec, embedding_dim=8, bottom_units=(16, 8), top_units=(16, 1), cross_layers=2,
               cross_rank=4, generator=torch.Generator().manual_seed(0), device="cpu")
    ids = torch.tensor([[0, 0, 6, 2, 2, 1], [4, 1, 6, 0, 2, 2],
                        [3, 3, 0, 1, 1, 1], [4, 0, 5, 0, 0, 0]])
    x = {"dense": torch.linspace(0.0, 1.0, 4 * 13).reshape(4, 13), "ids": ids}
    trainer = Trainer(net, TrainConfig(learning_rate=0.01, epochs=1), device="cpu")
    train = (x, torch.tensor([1.0, 0.0, 0.0, 1.0]))
    if not record_on:
        return fit_minibatch_sparse(trainer, 3, train, 2, optimizer="rowwise_adagrad"), None, ids
    with profiler.recording() as record:
        res = fit_minibatch_sparse(trainer, 3, train, 2, optimizer="rowwise_adagrad")
    return res, record.export(), ids


def test_the_sparse_step_and_dlrm_record_their_spans_and_counters(monkeypatch):
    res_on, out, ids = _sparse_dlrm_fit(True)
    names = [s["name"] for s in out["spans"]]
    step = ["train.lookup", "dlrm.bags", "dlrm.cross", "train.forward", "train.backward",
            "train.optimizer", "train.sparse_update"]
    assert names == step * 2  # in the order they end
    parents = {s["name"]: s["parent"] for s in out["spans"]}
    assert parents["train.lookup"] == parents["dlrm.bags"] == parents["dlrm.cross"] == \
        "train.forward"
    assert all(parents[n] is None for n in step[3:])
    order = epoch_order(3, 4, 1, 2)[0]  # the fit's two batches of two rows
    touched = sum(int(ids[rows][:, cols].unique().numel())
                  for rows in order for cols in (slice(0, 2), slice(2, 3), slice(3, 6)))
    assert out["counters"] == {"train.ids": 4 * 6, "train.rows_touched": touched}

    def called(*args, **kwargs):
        raise AssertionError("the off path called a torch API")

    monkeypatch.setattr(torch.profiler, "record_function", called)
    monkeypatch.setattr(torch.cuda, "Event", called)
    res_off, _, _ = _sparse_dlrm_fit(False)
    monkeypatch.undo()
    for k in res_on.params:
        assert torch.equal(res_on.params[k], res_off.params[k]), k
