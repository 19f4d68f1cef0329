"""The cost functions against hand counts and against the products the plain
references run, counted by ``torch.utils.flop_counter``."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import peaks, refcommon, spec, weights
from portbench.costs import deepfm, din, lookup

SMALL_DIN = {"model_kwargs": {"embed_size": 4, "attention_units": [6, 5, 1], "fc_units": [7, 3, 1]},
             "hist_len": 3, "fixture": {"num_items": 11}}
SMALL_DEEPFM = {"model_kwargs": {"embedding_dim": 4, "hidden_units": [8, 6, 2, 1]},
                "fixture": {"num_users": 9, "num_items": 13}}


def _flops(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def test_lookup_bounds_by_hand():
    # gather: 10 rows of 4 floats out, 10 int64 ids, 3 touched rows read
    assert lookup.gather_s(10, 4, 3, 8) == (10 * 4 * 4 + 10 * 8 + 3 * 4 * 4) / peaks.BYTES_PER_S
    # onehot_grad: ids and g read, the whole [V, D] gradient written
    assert lookup.onehot_grad_s(10, 4, 7, 4) == (10 * 4 + 10 * 16 + 7 * 16) / peaks.BYTES_PER_S


def test_bound_takes_the_largest_time():
    assert peaks.bound_s(495e12, 0, 0) == 1.0
    assert peaks.bound_s(0, 67e12, 0) == 1.0
    assert peaks.bound_s(1.0, 1.0, 3.35e12) == 1.0
    assert peaks.mfu_percent(495e12, 2.0) == 50.0


def test_din_row_products_by_hand():
    # D 2, L 3, A (4, 2, 1), F (3, 2, 1): a position 2*2*4 + 2*4*2 + 2*2 = 36;
    # a pair 2*2*4 (target term) + 2*4*3 + 2*3*2 + 2*2 = 56
    assert din.position_products(2, (4, 2, 1)) == 36
    assert din.pair_products(2, (4, 2, 1), (3, 2, 1)) == 56
    assert din.row_products(2, 3, (4, 2, 1), (3, 2, 1)) == 3 * 36 + 56


def _din_params(cfg, items):
    ref = spec.reference("din")
    return ref, weights.draw(ref.param_specs(cfg, 1, items), 0, torch.device("cpu"))


def test_din_costs_against_the_reference_products():
    """The reference builds [h, h - t, t] @ W1 (3D rows a position); the cost
    counts the least work, h @ (W_a + W_b) a position and t @ (W_c - W_b) a row."""
    cfg = SMALL_DIN
    B, L, D, A1 = 5, 3, 4, 6
    ref, p = _din_params(cfg, 11)
    hist = torch.randint(0, 11, (B, L))
    tgt = torch.randint(0, 11, (B,))
    with refcommon.precision("float32", torch.device("cpu")) as mm:
        got = _flops(lambda: ref.logits(mm, p, hist, tgt))
    ours = B * din.row_products(D, L, (6, 5, 1), (7, 3, 1))
    assert got - ours == B * (L * 2 * 2 * D * A1 - 2 * D * A1)


def test_din_train_unit_counts_epochs_and_evaluations():
    cfg = SMALL_DIN
    D, L, A, F = 4, 3, (6, 5, 1), (7, 3, 1)

    def split(n):
        return (torch.randint(0, 11, (n, L), dtype=torch.int32),
                torch.randint(0, 11, (n,), dtype=torch.int32)), torch.zeros(n)

    b = {"train": split(8), "valid": split(3), "test": split(2)}
    row = din.row_products(D, L, A, F)
    out = din.train_unit(cfg, b, epochs=5, track=True)
    assert out["products"] == 5 * (3 * 8 + 3 + 2) * row + (8 + 3 + 2) * row
    assert din.train_unit(cfg, b, epochs=5, track=False)["products"] == 5 * 3 * 8 * row
    assert out["bounds"]["din_head"] > 0 and out["bounds"]["lookup"] > 0


def test_din_refresh_counts_real_positions_only():
    cfg = SMALL_DIN
    inputs = {"users": [0, 0, 1, 1, 1, 2], "num_users": 3, "num_items": 11}
    got = din.refresh(cfg, inputs)["products"]
    assert got == 6 * 11 * din.position_products(4, (6, 5, 1)) + 3 * 11 * din.pair_products(
        4, (6, 5, 1), (7, 3, 1))


def _deepfm_params(cfg):
    ref = spec.reference("deepfm")
    fx = cfg["fixture"]
    return ref, weights.draw(ref.param_specs(cfg, fx["num_users"], fx["num_items"]), 0,
                             torch.device("cpu"))


def _rows(n, cfg):
    x = torch.rand(n, 45)
    x[:, 0] = torch.randint(0, cfg["fixture"]["num_users"], (n,)).float()
    x[:, 1] = torch.randint(0, cfg["fixture"]["num_items"], (n,)).float()
    return x


@pytest.mark.parametrize("train", [False, True])
def test_deepfm_costs_equal_the_reference_products(train):
    cfg = SMALL_DEEPFM
    ref, p = _deepfm_params(cfg)
    x, y = _rows(7, cfg), torch.randint(0, 2, (7,)).float()
    leaves = {k: v.clone().requires_grad_(train) for k, v in p.items()}
    with refcommon.precision("float32", torch.device("cpu")) as mm:
        if train:
            got = _flops(lambda: ref.train_loss(mm, cfg, leaves, x, y).backward())
        else:
            got = _flops(lambda: ref.logits(mm, leaves, x, 3))
    per_row = (deepfm.train_row_products if train else deepfm.row_products)(4, [8, 6, 2, 1])
    assert got == 7 * per_row


def test_deepfm_step_matches_the_scaling_models_count():
    """295.8 GFLOP a training step at the preset's widths on 87,900 rows, as
    ``runtime/scaling_model.py::program_costs`` counted it on the card."""
    step = 87_900 * deepfm.train_row_products(128, [512, 256, 128, 1])
    assert step == pytest.approx(295.8e9, rel=5e-4)


def test_deepfm_refresh_is_every_pair_once():
    cfg = spec.config("deepfm-ml100k")
    got = deepfm.refresh(cfg, {"num_users": 943, "num_items": 1682})["products"]
    assert got == 943 * 1682 * deepfm.row_products(128, [512, 256, 128, 1])
    assert got == pytest.approx(1.786e12, rel=1e-3)
