"""The benchmark's own parse of the fixture, and the batches it builds for
the references, agree with the program's where the program is sound and
count every row where it is not."""

from __future__ import annotations

import tempfile

import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.experiments import split_batches

from portbench import feed, spec
from portbench.program import experiment_config

FIXTURE = {"seed": 0, "num_users": 60, "num_items": 300, "num_ratings": 3000}
SEED = 2**31 + 5


@pytest.fixture(scope="module")
def both():
    with tempfile.TemporaryDirectory() as path:
        write_ml100k_format(path, **FIXTURE)
        return MovieLens100K(path, seed=SEED), feed.parse(path)


def test_the_parse_agrees_with_the_program_s_loader(both):
    data, raw = both
    assert (raw.num_users, raw.num_items) == (data.num_users, data.num_items)
    assert np.array_equal(raw.users, data.data["user"]) and np.array_equal(raw.items, data.data["item"])
    assert np.array_equal(raw.user_features, data.user_features)
    assert np.array_equal(raw.item_features, data.item_features)
    assert feed.features_mismatch(raw, torch.from_numpy(data.user_features),
                                  torch.from_numpy(data.item_features)) == 0
    full = [row[row >= 0] for row in data.itemid_matrix(data.data)]
    assert feed.histories_mismatch(raw, full) == 0
    full[7] = full[7][::-1]
    assert feed.histories_mismatch(raw, full) == 1


def _batch(config_name, data):
    cfg = experiment_config(spec.config(config_name), SEED)
    return cfg, split_batches(cfg, data, torch.device("cpu"))["train"]


def test_deepfm_rows_match_and_a_changed_column_counts(both):
    data, raw = both
    _, (batch, labels) = _batch("deepfm-ml100k", data)
    rows, y, mismatch = feed.feature_batch(raw, data.train, batch, labels)
    assert mismatch == 0 and torch.equal(rows, batch) and torch.equal(y, labels)
    bad = batch.clone()
    bad[5, 30] += 1.0  # a genre flag
    bad[9, 0] = (bad[9, 0] + 1) % raw.num_users  # a positive's user
    assert feed.feature_batch(raw, data.train, bad, labels)[2] >= 2


def test_din_windows_match_and_a_wrong_window_counts(both):
    data, raw = both
    cfg, ((hist, target), labels) = _batch("din-ml100k", data)
    (ref_hist, ref_target), y, mismatch = feed.history_batch(raw, data.train, (hist, target),
                                                             labels, cfg.hist_len)
    assert mismatch == 0
    assert torch.equal(ref_hist, hist.long()) and torch.equal(ref_target, target.long())
    last = data.history_matrix(data.train, cfg.hist_len + 3)[:, 3:]  # keep-last, not keep-first
    wrong = torch.from_numpy(last).long()[torch.as_tensor(
        np.concatenate([data.train["user"], np.repeat(np.arange(raw.num_users), cfg.negatives[0])]))]
    assert feed.history_batch(raw, data.train, (wrong, target), labels, cfg.hist_len)[2] > 0
