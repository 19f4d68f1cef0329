"""The fused trainers' segment builder (``ops/segments.py::id_segments``)
against a numpy stable argsort and bincount on seeded ids."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu_torch.ops.segments import id_segments


def _ids(kind: str, B: int, V: int, rng: np.random.Generator) -> np.ndarray:
    if kind == "grouped":  # sorted by id, as a batch grouped by user
        return np.sort(rng.integers(0, V, B))
    if kind == "shuffled":
        return rng.permutation(np.repeat(np.arange(V), B // V + 1)[:B])
    if kind == "skewed":  # one id holds a quarter of the rows
        ids = rng.integers(0, V, B)
        ids[rng.random(B) < 0.25] = V // 3
        return ids
    if kind == "out_of_range":  # ids below 0 and of V or more match no segment
        return rng.integers(-4, V + 4, B)
    if kind == "sparse":  # most ids have no row: empty segments
        return rng.choice(np.array([1, 5, V - 1]), B)
    raise ValueError(kind)


def _check(ids_np: np.ndarray, V: int, dtype) -> None:
    order, offsets = id_segments(torch.from_numpy(ids_np).to(dtype), V)
    assert order.dtype == offsets.dtype == torch.int64
    assert offsets.shape == (V + 1,)
    want_order = np.argsort(np.clip(ids_np, -1, V), kind="stable")
    np.testing.assert_array_equal(order.numpy(), want_order)
    valid = ids_np[(ids_np >= 0) & (ids_np < V)]
    counts = np.bincount(valid, minlength=V)
    np.testing.assert_array_equal(np.diff(offsets.numpy()), counts)
    assert int(offsets[0]) == int((ids_np < 0).sum())
    assert int(offsets[V]) == int((ids_np < V).sum())
    o = order.numpy()
    for v in np.flatnonzero(counts)[:50]:  # each segment holds its id's rows in row order
        rows = o[offsets[v]:offsets[v + 1]]
        assert (ids_np[rows] == v).all() and (np.diff(rows) > 0).all()
    outside = np.concatenate([o[:offsets[0]], o[offsets[V]:]])
    assert ((ids_np[outside] < 0) | (ids_np[outside] >= V)).all()


@pytest.mark.parametrize("kind", ["grouped", "shuffled", "skewed", "out_of_range", "sparse"])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("B,V", [(1_000, 37), (20_000, 1_682), (7, 3), (5_000, 40_000)])
def test_id_segments_matches_numpy(kind, dtype, B, V):
    rng = np.random.default_rng(B + V + len(kind))
    _check(_ids(kind, B, V, rng), V, dtype)


def test_skewed_segment_holds_its_share():
    rng = np.random.default_rng(0)
    ids = _ids("skewed", 10_000, 100, rng)
    _, offsets = id_segments(torch.from_numpy(ids), 100)
    assert int(offsets[34] - offsets[33]) >= 2_000  # id V // 3 = 33 holds >= 20% of the rows


def test_id_segments_rejects_bad_input():
    with pytest.raises(ValueError):
        id_segments(torch.zeros(4), 3)  # float ids
    with pytest.raises(ValueError):
        id_segments(torch.zeros((2, 2), dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        id_segments(torch.zeros(4, dtype=torch.int64), 0)
