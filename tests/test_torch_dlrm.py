"""DLRM-DCNv2 (``models/dlrm.py``) against the plain reference
(``tests/dlrm_reference.py``) on the CPU: the published structure (26 bags
at their published hotness, D 128, the 13-512-256-128 bottom MLP, three
cross layers of rank 512, the 3456-1024-1024-512-256-1 top MLP) over small
tables.

Tolerances. Both sides compute in float32 from the same weights; they differ
in the order of their sums (a bag's rows, a product's terms, the dedup's
gradient sums against autograd's scatter), so a value agrees to a few float32
roundings of its size: ``rtol`` 1e-5 on logits, losses and gradients. A
trained leaf is held by its change from the initial weights as a whole
(``CHANGE_GAP``): Adam moves each element by ``lr`` times m_hat / sqrt(v_hat),
so an element whose gradient is at rounding level moves by up to ``lr`` either
way on either side, and row-wise AdaGrad divides a row by its gradient's
root mean square. The leaves' changes agree to 5e-5 of their norm after
three steps here; ``CHANGE_GAP`` is four times that.
"""

import numpy as np
import torch

import dlrm_reference as ref
from deeplearningrecommendationsystem_tpu_torch.models.dlrm import (
    CRITEO_1TB_HOTNESS,
    CRITEO_1TB_ROWS,
    DLRM,
    BagSpec,
    pool_bags,
)
from deeplearningrecommendationsystem_tpu_torch.ops import embedding, gather
from deeplearningrecommendationsystem_tpu_torch.ops.interactions import low_rank_cross
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.train.minibatch import epoch_order
from deeplearningrecommendationsystem_tpu_torch.train.sparse_trainer import fit_minibatch_sparse

HEIGHTS = tuple(min(v, 37) for v in CRITEO_1TB_ROWS)
SPEC = BagSpec(HEIGHTS, CRITEO_1TB_HOTNESS)
B = 16
TOL = dict(rtol=1e-5, atol=1e-6)
CHANGE_GAP = 2e-4


def _change_gap(got, want, start):
    """The norm of the gap between two changes from ``start``, against the
    reference's change."""
    return float(((got - start) - (want - start)).norm() / (want - start).norm())


def _model(seed=0):
    net = DLRM(SPEC, generator=torch.Generator().manual_seed(seed), device="cpu")
    with torch.no_grad():  # a nonzero cross bias, so that where it sits shows
        for name, p in net.named_parameters():
            if name.startswith("cross.") and name.endswith(".b"):
                p.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed + 1))
    return net


def _batch(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.cat([torch.randint(0, v, (n, h), generator=g)
                     for v, h in zip(SPEC.heights, SPEC.hotness)], dim=1)
    dense = torch.log1p(torch.floor(torch.exp(2.0 * torch.randn(n, 13, generator=g))))
    labels = (torch.rand(n, generator=g) < 0.25).float()
    return {"dense": dense, "ids": ids}, labels


def _params(net):
    """The model's parameters under the reference's names: ``tables`` split
    into ``tables.{f}``."""
    p = {k: v.detach().clone() for k, v in net.named_parameters()}
    return _split(p)


def _split(p):
    out = {k: v for k, v in p.items() if k != "tables"}
    out.update({f"tables.{f}": p["tables"][o:o + v]
                for f, (o, v) in enumerate(zip(SPEC.row_offsets, SPEC.heights))})
    return out


def test_the_published_layout():
    assert len(CRITEO_1TB_ROWS) == len(CRITEO_1TB_HOTNESS) == 26
    full = BagSpec(CRITEO_1TB_ROWS, CRITEO_1TB_HOTNESS)
    assert sum(full.hotness) == 214 and full.offsets[:3] == (0, 3, 5)
    assert sum(CRITEO_1TB_ROWS) == 204_184_588
    assert full.row_offsets[:3] == (0, 40_000_000, 40_039_060)
    net = _model()
    shapes = {k: tuple(v.shape) for k, v in net.named_parameters()}
    assert shapes["tables"] == (sum(HEIGHTS), 128)
    assert shapes["cross.0.v"] == (3456, 512) and shapes["cross.2.w"] == (512, 3456)
    assert shapes["bottom.0.w"] == (13, 512) and shapes["top.0.w"] == (3456, 1024)
    assert shapes["top.4.w"] == (256, 1)
    x, _ = _batch(2)
    ids = net.table_ids(x)["tables"].reshape(2, 214)
    for f, (o, h) in enumerate(zip(SPEC.offsets, SPEC.hotness)):  # each id into its own table
        assert torch.equal(ids[:, o:o + h], x["ids"][:, o:o + h] + SPEC.row_offsets[f])


def test_logits_loss_and_gradients_match_the_reference():
    net = _model()
    x, y = _batch(B)
    p = _params(net)
    got = net(x)
    want = ref.logits(p, x["dense"], x["ids"], SPEC.hotness)
    torch.testing.assert_close(got, want, **TOL)
    loss = torch.nn.functional.binary_cross_entropy_with_logits(got, y)
    loss.backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    ref_loss = ref.bce(ref.logits(leaves, x["dense"], x["ids"], SPEC.hotness), y)
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss, **TOL)
    grads = _split({n: q.grad for n, q in net.named_parameters()})
    for name, g in grads.items():
        torch.testing.assert_close(g, leaves[name].grad, **TOL, msg=name)


def test_the_cross_bias_is_inside_the_product():
    g = torch.Generator().manual_seed(3)
    x0 = torch.randn(5, 12, generator=g)
    layer = {"v": torch.randn(12, 4, generator=g), "w": torch.randn(4, 12, generator=g),
             "b": torch.randn(12, generator=g)}
    got = low_rank_cross([layer], x0)
    inside = x0 * ((x0 @ layer["v"]) @ layer["w"] + layer["b"]) + x0
    outside = x0 * ((x0 @ layer["v"]) @ layer["w"]) + layer["b"] + x0
    torch.testing.assert_close(got, inside)
    assert (got - outside).abs().max() > 0.1


def test_three_rowwise_adagrad_steps_match_the_reference():
    """``fit_minibatch_sparse(optimizer="rowwise_adagrad")`` for one epoch of
    three batches: the step losses, the rows the batches touch, every other
    row bit for bit, and the dense leaves."""
    lr, seed = 0.005, 11
    net = _model()
    w0 = _params(net)
    x, y = _batch(3 * B, seed=1)
    trainer = Trainer(net, TrainConfig(learning_rate=lr, epochs=1), device="cpu")
    res = fit_minibatch_sparse(trainer, seed, (x, y), B, optimizer="rowwise_adagrad",
                               step_losses=True)
    order = epoch_order(seed, 3 * B, 1, B)[0]
    steps = [(x["dense"][i], x["ids"][i], y[i]) for i in order]
    losses, want, accum = ref.train(w0, steps, SPEC.hotness, lr)
    assert res.history["step_loss"].shape == (3,)
    np.testing.assert_allclose(res.history["step_loss"].numpy(), losses, rtol=1e-5)
    torch.testing.assert_close(res.history["train_loss"][0], res.history["step_loss"].mean())
    got = _split(res.params)
    got_accum = res.opt_state["sparse"]["tables"].accum
    for f, (o, h) in enumerate(zip(SPEC.offsets, SPEC.hotness)):
        name = f"tables.{f}"
        touched = torch.zeros(HEIGHTS[f], dtype=torch.bool)
        touched[x["ids"][:, o:o + h].reshape(-1)] = True
        assert torch.equal(got[name][~touched], w0[name][~touched]), name
        assert bool((got[name][touched] != w0[name][touched]).all(dim=1).any()), name
        assert _change_gap(got[name][touched], want[name][touched],
                           w0[name][touched]) < CHANGE_GAP, name
        row = SPEC.row_offsets[f]
        torch.testing.assert_close(got_accum[row:row + HEIGHTS[f]], accum[name], **TOL)
    for name in w0:
        if not name.startswith("tables."):
            assert _change_gap(got[name], want[name], w0[name]) < CHANGE_GAP, name


def test_bags_pooled_over_eight_row_blocks_sum_to_the_whole():
    """The chip's share: each of 8 row blocks of every table, with the other
    blocks' ids turned into the block's padding slot (a zero row) as the
    sparse trainer's ``_local_ids`` turns them, pools a partial bag; the
    partial bags sum to the uncut reference's bags, and the logits from
    them agree with the uncut reference's."""
    net = _model()
    x, _ = _batch(B)
    p = _params(net)
    partial = []
    for f, (o, h, v) in enumerate(zip(SPEC.offsets, SPEC.hotness, HEIGHTS)):
        ids, rows, bag = x["ids"][:, o:o + h].reshape(-1), -(-v // 8), torch.zeros(B, 128)
        for r in range(8):
            block = p[f"tables.{f}"][r * rows:(r + 1) * rows]
            padded = torch.cat([block, torch.zeros(1, 128)])
            local = ids - r * rows
            local = torch.where((local >= 0) & (local < block.shape[0]), local, block.shape[0])
            bag += pool_bags(embedding.gather_rows(padded, local).reshape(B, h, 128))
        partial.append(bag)
    whole = ref.bags(p, x["ids"], SPEC.hotness)
    for f in range(len(HEIGHTS)):
        torch.testing.assert_close(partial[f], whole[f], **TOL)
    dense = {n: t for n, t in net.named_parameters() if n != "tables"}
    rows = {"tables": embedding.gather_rows(net.tables.detach(), net.table_ids(x)["tables"])}
    got = net.apply_rows(dense, rows, x)
    torch.testing.assert_close(got, ref.head(p, x["dense"], partial), **TOL)
    torch.testing.assert_close(got, ref.logits(p, x["dense"], x["ids"], SPEC.hotness), **TOL)


def test_every_lookup_goes_through_the_gather_wrapper_and_no_table_gradient_forms(monkeypatch):
    seen = []
    def counted(table, ids):
        seen.append(table.shape[0])
        return gather.gather_rows_kernel_plain(table, ids)

    monkeypatch.setattr(embedding, "gather_rows_kernel", counted)

    def no_onehot(*args):
        raise AssertionError("onehot_grad ran")

    monkeypatch.setattr(embedding, "onehot_grad", no_onehot)
    net = _model()
    x, y = _batch(2 * B)
    trainer = Trainer(net, TrainConfig(learning_rate=0.01, epochs=1), device="cpu")
    fit_minibatch_sparse(trainer, 0, (x, y), B, optimizer="rowwise_adagrad")
    assert seen == [sum(HEIGHTS)] * 2  # one lookup into every table a step, two steps
    assert net.tables.grad is None
