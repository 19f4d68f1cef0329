"""The port's DIN against the JAX package's, on the same NumPy inputs and
weights (``params_from_jax``), at a small width: 200 items, D 16, attention
(32, 16, 1), fc (64, 32, 1), L 10.

* ``apply_params`` against JAX ``DIN.apply`` (rtol 1e-5, atol 1e-6) and the
  parameter gradients (rtol 1e-3, atol 1e-5, the JAX test's for its fused
  flag), unmasked (the kernel route, the JAX kernel flags accepted) and with
  ``mask_padding``; ``apply_full`` and ``indirect_hist`` likewise;
* both catalog scorers against JAX's ``score_catalog`` (atol 1e-5): the
  window scorer and the bucketed full-history scorer with small buckets;
* N Trainer epochs against the JAX ``Trainer`` on the same batch (losses
  rtol 1e-5, params atol 5e-5), and under bfloat16 compute against the JAX
  DIN's Pallas head (losses rtol 1e-5, params atol 5e-4);
* ``run_experiment(PRESETS["din"])`` in both packages on a synthetic
  ml-100k-format dataset, the port fed the JAX sampler's draws and initial
  params, with full-history and window serving; tolerances as
  ``tests/test_torch_experiments.py`` states them, but the raw AUCs atol 1e-4
  and the ranking metrics atol 1e-5 (after 3 epochs at lr 1e-3 the logits are
  near 0, and a few nearly equal scores swap places);
* nets of one and three hidden layers and a history of 80, which
  ``ops/din_head.py::kernel_route`` sends to the composition: logits, grads,
  one Trainer epoch and the window scorer against the JAX DIN's default
  route, at the tolerances above; ``kernel_route`` on the preset's shapes and
  on each shape it refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu import experiments as jax_experiments
from deeplearningrecommendationsystem_tpu.configs import PRESETS as JAX_PRESETS
from deeplearningrecommendationsystem_tpu.data import MovieLens100K as JaxMovieLens
from deeplearningrecommendationsystem_tpu.models import DIN as JaxDIN
from deeplearningrecommendationsystem_tpu.models.base import ServingContext as JaxCtx
from deeplearningrecommendationsystem_tpu.models.base import (
    catalog_scores_full_history as jax_full_history,
)
from deeplearningrecommendationsystem_tpu.sampling import NegativeSampler as JaxSampler
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu_torch import experiments
from deeplearningrecommendationsystem_tpu_torch.cli import serve
from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.models import DIN, ServingContext
from deeplearningrecommendationsystem_tpu_torch.models.base import catalog_scores_full_history
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.weights import opt_state_from_jax, params_from_jax

I, D, L, B = 200, 16, 10, 64
KW = {"embed_size": D, "attention_units": (32, 16, 1), "fc_units": (64, 32, 1)}
THRESHOLDED = ("accuracy", "precision", "recall", "f1", "auc")


def _flat(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        nested = isinstance(v, (dict, list, tuple))
        out.update(_flat(v, f"{prefix}{k}.") if nested else {f"{prefix}{k}": np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, JaxDIN(I, **KW).init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, I, (B, L))
    hist[:5, :4] = 0  # a left zero-pad run, which mask_padding masks
    target = rng.integers(0, I, B)
    y = (rng.random(B) < 0.5).astype(np.float32)
    return hist, target, y


def _port(params, **flags):
    return params_from_jax(DIN(I, **KW, **flags, device="cpu"), params)


def _bce(lg, y):
    return (lg.clamp_min(0) - lg * y + torch.log1p(torch.exp(-lg.abs()))).mean()


def _jax_bce(lg, y):
    return jnp.mean(jnp.maximum(lg, 0) - lg * y + jnp.log1p(jnp.exp(-jnp.abs(lg))))


@pytest.mark.parametrize("flags", [{}, {"fused_head": True, "pallas_serving": True},
                                   {"mask_padding": True}],
                         ids=["unmasked", "jax_kernel_flags", "mask_padding"])
def test_apply_and_grads_match_jax(params, batch, flags):
    hist, target, y = batch
    jmodel = JaxDIN(I, **KW, mask_padding=flags.get("mask_padding", False))

    def jax_loss(p):
        lg = jmodel.apply(p, (jnp.asarray(hist), jnp.asarray(target)))
        return _jax_bce(lg, y), lg

    (v_want, lg_want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model = _port(params, **flags)
    lg = model((torch.from_numpy(hist), torch.from_numpy(target)))
    loss = _bce(lg, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(lg_want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(v_want), rtol=1e-5)
    g_want = _flat(g_want)
    named = dict(model.named_parameters())
    assert named.keys() == g_want.keys()
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), g_want[k], rtol=1e-3, atol=1e-5, err_msg=k)


def test_mask_padding_changes_only_padded_rows(params, batch):
    hist, target, _ = batch
    b = (torch.from_numpy(hist), torch.from_numpy(target))
    with torch.no_grad():
        plain, masked = _port(params)(b), _port(params, mask_padding=True)(b)
    assert not torch.allclose(plain[:5], masked[:5])
    np.testing.assert_allclose(plain[5:].numpy(), masked[5:].numpy(), rtol=1e-5, atol=1e-6)


def test_indirect_hist_equals_the_standard_batch(params):
    """The (hist_u [U, L], user_idx [B], target [B]) batch: the same logits (the
    same gathers composed) and gradients up to the order of the table sums."""
    rng = np.random.default_rng(1)
    U = 12
    hist_u = torch.from_numpy(rng.integers(0, I, (U, L)))
    uidx = torch.from_numpy(rng.integers(0, U, B))
    target = torch.from_numpy(rng.integers(0, I, B))
    cot = torch.from_numpy(rng.normal(size=B).astype(np.float32))
    for mask_padding in (False, True):
        std = _port(params, mask_padding=mask_padding)
        ind = _port(params, mask_padding=mask_padding, indirect_hist=True)
        out_std = std((hist_u[uidx], target))
        out_ind = ind((hist_u, uidx, target))
        np.testing.assert_array_equal(out_std.detach().numpy(), out_ind.detach().numpy())
        (out_std * cot).sum().backward()
        (out_ind * cot).sum().backward()
        for (k, a), b in zip(std.named_parameters(), ind.parameters()):
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=2e-5, atol=1e-6,
                                       err_msg=k)
    # a 2-tuple batch takes the standard path
    np.testing.assert_array_equal(ind((hist_u[uidx], target)).detach().numpy(),
                                  out_std.detach().numpy())


def test_apply_full_matches_jax(params):
    rng = np.random.default_rng(2)
    hist = rng.integers(0, I, (B, 24))
    target = rng.integers(0, I, B)
    length = rng.integers(1, 25, B)
    want = JaxDIN(I, **KW).apply_full(jax.tree.map(jnp.asarray, params),
                                      tuple(map(jnp.asarray, (hist, target, length))))
    with torch.no_grad():
        got = _port(params).apply_full(_port(params).params(),
                                       tuple(map(torch.from_numpy, (hist, target, length))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _ctx(U, **kw):
    return ServingContext(torch.zeros((U, 24)), torch.zeros((I, 19)), **kw)


def test_window_catalog_scores_match_jax(params):
    """``ctx.history``: the window scorer (the DIN attention pool's route), 37
    users so that the last tile of 16 is short."""
    U = 37
    history = np.random.default_rng(3).integers(0, I, (U, L)).astype(np.int32)
    want = JaxDIN(I, **KW).score_catalog(
        jax.tree.map(jnp.asarray, params),
        JaxCtx(jnp.zeros((U, 24)), jnp.zeros((I, 19)), history=jnp.asarray(history)))
    with torch.no_grad():
        got = _port(params).score_catalog(_ctx(U, history=torch.from_numpy(history)))
    assert got.shape == (U, I)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="ctx.history"):
        _port(params).score_catalog(_ctx(U))


def _histories(U, seed=0, max_len=37):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, I, rng.integers(1, max_len + 1)).astype(np.int32) for _ in range(U)]


HISTORY_CASES = {
    "buckets_8_16_64": ((8, 16, 64), _histories(13)),
    "bucket_40": ((40,), _histories(13)),
    "bucket_edges": ((8, 16), [np.random.default_rng(7).integers(0, I, n).astype(np.int32)
                               for n in (1, 8, 9, 16, 17, 16, 8, 1)]),
    "item_zero": ((8,), [np.array([0, 3, 0, 5], np.int32), np.array([0], np.int32)]),
}


@pytest.mark.parametrize("case", list(HISTORY_CASES))
@pytest.mark.parametrize("embed_once", [False, True])
def test_full_history_scores_match_jax(params, case, embed_once):
    buckets, histories = HISTORY_CASES[case]
    jmodel, model = JaxDIN(I, **KW), _port(params)
    jp = jax.tree.map(jnp.asarray, params)
    want = jax_full_history(jmodel.apply_full, jp, histories, I, buckets=buckets)
    fns = {}
    if embed_once:
        fns = {"embed_fn": lambda p, h: model.item[h], "apply_embedded_fn": model.apply_full_embedded}
    with torch.no_grad():
        got = catalog_scores_full_history(model.apply_full, model.params(), histories, I, "cpu",
                                          buckets=buckets, **fns)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_score_catalog_dispatches_on_full_histories(params):
    histories = _histories(6, seed=5, max_len=12)
    want = JaxDIN(I, **KW).score_catalog(
        jax.tree.map(jnp.asarray, params),
        JaxCtx(jnp.zeros((6, 24)), jnp.zeros((I, 19)), full_histories=histories))
    ctx = _ctx(6, history=torch.zeros((6, L), dtype=torch.int64), full_histories=histories)
    with torch.no_grad():
        got = _port(params).score_catalog(ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # ServingContext.to carries the window across and leaves the histories on the host
    moved = ctx.to(torch.device("cpu"))
    assert moved.full_histories is histories and torch.equal(moved.history, ctx.history)


def test_trainer_matches_jax(params, batch):
    """Three full-batch epochs with metrics in both packages from the same
    weights; then two more from the JAX params and Adam state."""
    hist, target, y = batch
    jb = ((jnp.asarray(hist), jnp.asarray(target)), jnp.asarray(y))
    tb = ((torch.from_numpy(hist), torch.from_numpy(target)), torch.from_numpy(y))
    jcfg = dict(learning_rate=1e-3, weight_decay=1e-5, epochs=3)
    want = JaxTrainer(JaxDIN(I, **KW), JaxConfig(**jcfg)).fit(
        jax.random.PRNGKey(0), jb, valid=jb, test=jb, params=jax.tree.map(jnp.asarray, params))
    model = _port(params)
    got = Trainer(model, TrainConfig(**jcfg), device="cpu").fit(tb, valid=tb, test=tb)
    assert set(got.history) == set(want.history)
    for key, w in want.history.items():
        metric = key.split("_", 1)[1]
        if key == "_param_checksum":
            np.testing.assert_allclose(got.history[key].numpy(), w, rtol=1e-5, err_msg=key)
        elif metric in THRESHOLDED:
            np.testing.assert_array_equal(got.history[key].numpy(), w, err_msg=key)
        else:
            np.testing.assert_allclose(got.history[key].numpy(), w, rtol=1e-5, err_msg=key)
    want_params = _flat(want.params)
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=5e-5, err_msg=k)

    again = JaxTrainer(JaxDIN(I, **KW), JaxConfig(**dict(jcfg, epochs=2))).fit(
        jax.random.PRNGKey(0), jb, params=want.params, opt_state=want.opt_state)
    model = params_from_jax(DIN(I, **KW, device="cpu"), jax.tree.map(np.asarray, want.params))
    resumed = Trainer(model, TrainConfig(**dict(jcfg, epochs=2, track_metrics=False)),
                      device="cpu").fit(tb, opt_state=opt_state_from_jax(model, want.opt_state))
    np.testing.assert_allclose(resumed.history["train_loss"].numpy(),
                               np.asarray(again.history["train_loss"]), rtol=1e-5)


def test_trainer_bfloat16_matches_jax(params, batch, monkeypatch):
    """Three epochs under ``compute_dtype="bfloat16"``: the JAX DIN with
    ``fused_head=True`` (the Pallas head, in interpret mode), as the port always
    trains through its head. Both round the same operands to bf16, but sums in
    another order can land a value on the other bf16 neighbour, and Adam's
    normalised steps carry that: losses rtol 1e-5, params atol 5e-4
    (measured: 1.8e-7 and 6.8e-5)."""
    import functools

    import deeplearningrecommendationsystem_tpu.ops.pallas.din_head as jax_head

    monkeypatch.setattr(jax_head, "din_head_fused",
                        functools.partial(jax_head.din_head_fused, interpret=True,
                                          block_rows=32, bwd_block_rows=32))
    hist, target, y = batch
    jb = ((jnp.asarray(hist), jnp.asarray(target)), jnp.asarray(y))
    tb = ((torch.from_numpy(hist), torch.from_numpy(target)), torch.from_numpy(y))
    jcfg = dict(learning_rate=1e-3, weight_decay=1e-5, epochs=3, compute_dtype="bfloat16")
    want = JaxTrainer(JaxDIN(I, **KW, fused_head=True), JaxConfig(**jcfg)).fit(
        jax.random.PRNGKey(0), jb, valid=jb, test=jb, params=jax.tree.map(jnp.asarray, params))
    got = Trainer(_port(params), TrainConfig(**jcfg), device="cpu").fit(tb, valid=tb, test=tb)
    for key in ("train_loss", "valid_loss", "test_loss"):
        np.testing.assert_allclose(got.history[key].numpy(), np.asarray(want.history[key]),
                                   rtol=1e-5, err_msg=key)
    want_params = _flat(want.params)
    for k, v in got.params.items():
        assert v.dtype == torch.float32  # f32 master weights
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=5e-4, err_msg=k)


# ---- run_experiment and build_server on a synthetic dataset

U_DS, I_DS, R_DS, EPOCHS = 60, 150, 3000, 3
NARROW = {"model_kwargs": dict(KW)}


class _JaxDraws:
    """Stands in for the port's NegativeSampler: the JAX sampler's arrays."""

    def __init__(self, excluded, seed=0, device="cpu"):
        self._inner = JaxSampler(excluded, seed=seed)

    def sample(self, n):
        return {k: np.array(v) for k, v in self._inner.sample(n).items()}


def _jax_init_model(cfg, data, generator=None):
    p = JaxDIN(data.num_items, **cfg.model_kwargs).init(jax.random.PRNGKey(cfg.seed))
    return params_from_jax(DIN(data.num_items, **cfg.model_kwargs, device="cpu"),
                           jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    return write_ml100k_format(str(tmp_path_factory.mktemp("mld")), seed=5, num_users=U_DS,
                               num_items=I_DS, num_ratings=R_DS)


@pytest.mark.parametrize("full_history", [True, False], ids=["full_history", "window"])
def test_run_experiment_matches_jax(dataset_dir, full_history):
    over = dict(epochs=EPOCHS, full_history_serving=full_history, **NARROW)
    mp = pytest.MonkeyPatch()
    mp.setattr(experiments, "NegativeSampler", _JaxDraws)
    mp.setattr(experiments, "build_model", _jax_init_model)
    try:
        jx = JaxMovieLens(dataset_dir, seed=0, use_native=False)
        pt = MovieLens100K(dataset_dir, seed=0)
        want = jax_experiments.run_experiment(JAX_PRESETS["din"].replace(**over), data=jx)
        got = experiments.run_experiment(PRESETS["din"].replace(**over), data=pt, device="cpu")
    finally:
        mp.undo()
    assert got.model == "din" and got.train_examples == want.train_examples
    assert (got.ctx.full_histories is not None) == full_history
    assert tuple(got.ctx.history.shape) == (U_DS, 10)
    for key, w in want.history.items():
        metric = key.split("_", 1)[1]
        if key == "_param_checksum":
            np.testing.assert_allclose(got.history[key], w, rtol=1e-5, err_msg=key)
        elif metric in THRESHOLDED:
            np.testing.assert_array_equal(got.history[key], w, err_msg=key)
        else:
            np.testing.assert_allclose(got.history[key], w, rtol=1e-5, err_msg=key)
    # the raw AUCs rank every prediction: after 3 epochs the logits are near 0
    # and a few nearly equal pairs may swap, each moving the AUC by 1 / (P N)
    for key in want.extras:
        np.testing.assert_allclose(got.extras[key], want.extras[key], atol=1e-4, err_msg=key)
    want_params = _flat(want.params)
    assert got.params.keys() == want_params.keys()
    for key, w in want_params.items():
        np.testing.assert_allclose(got.params[key].numpy(), w, atol=5e-5, err_msg=key)
    assert got.ranking.keys() == want.ranking.keys()
    for split in want.ranking:
        for m, w in want.ranking[split].items():
            # as the AUCs: two nearly equal scores may swap places in a list
            np.testing.assert_allclose(got.ranking[split][m], w, rtol=1e-6, atol=1e-5,
                                       err_msg=f"{split} {m}")


def test_build_server_serves_din(dataset_dir):
    """``cli/serve.py --model din --device cpu``: the preset's full-history
    serving; the answer is the stable top-k of the trained model's masked
    scores, with no seen item."""
    args = serve.parser().parse_args(["--model", "din", "--data", dataset_dir, "--epochs", "2",
                                      "--port", "0", "--device", "cpu"])
    server = serve.build_server(args)
    try:
        code, payload = server.dispatch("POST", "/v1/recommend", {"users": [0, 7, 59], "k": 10})
        assert code == 200
        rec = server.recommender
        assert rec.ctx.full_histories is not None
        with torch.no_grad():
            masked = torch.where(rec.seen, -1e30, rec.model.score_catalog(rec.ctx))
        for row, u in enumerate((0, 7, 59)):
            order = sorted(range(I_DS), key=lambda i: (-masked[u, i].item(), i))
            assert payload["items"][row] == order[:10]
            assert not rec.seen[u, payload["items"][row]].any()
    finally:
        server.httpd.server_close()


# Nets of another depth, and a history longer than the kernels take: the
# composition route (``kernel_route`` False), against the JAX DIN's default
# route, which is the same composition. The parent tree raised on all three.
OTHER_SHAPES = {
    "attention_depth_1": ({"attention_units": (64, 1)}, L),
    "fc_depth_3": ({"fc_units": (200, 80, 40, 1)}, L),
    "history_80": ({}, 80),
}


def _other(case):
    flags, hist_len = OTHER_SHAPES[case]
    kw = dict(KW, **flags)
    p = jax.tree.map(np.asarray, JaxDIN(I, **kw).init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    hist = rng.integers(0, I, (B, hist_len))
    target = rng.integers(0, I, B)
    y = (rng.random(B) < 0.5).astype(np.float32)
    return kw, p, hist, target, y


@pytest.mark.parametrize("case", list(OTHER_SHAPES))
def test_other_depths_and_lengths_match_jax(case):
    kw, p, hist, target, y = _other(case)
    jmodel = JaxDIN(I, **kw)

    def jax_loss(q):
        lg = jmodel.apply(q, (jnp.asarray(hist), jnp.asarray(target)))
        return _jax_bce(lg, y), lg

    (v_want, lg_want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, p))
    model = params_from_jax(DIN(I, **kw, device="cpu"), p)
    lg = model((torch.from_numpy(hist), torch.from_numpy(target)))
    loss = _bce(lg, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(lg_want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(v_want), rtol=1e-5)
    g_want = _flat(g_want)
    named = dict(model.named_parameters())
    assert named.keys() == g_want.keys()
    for k, t in named.items():
        np.testing.assert_allclose(t.grad.numpy(), g_want[k], rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", list(OTHER_SHAPES))
def test_other_depths_and_lengths_train_and_serve_like_jax(case):
    """One Trainer epoch with metrics, then the window catalog scorer."""
    kw, p, hist, target, y = _other(case)
    jb = ((jnp.asarray(hist), jnp.asarray(target)), jnp.asarray(y))
    tb = ((torch.from_numpy(hist), torch.from_numpy(target)), torch.from_numpy(y))
    jcfg = dict(learning_rate=1e-3, weight_decay=1e-5, epochs=1)
    want = JaxTrainer(JaxDIN(I, **kw), JaxConfig(**jcfg)).fit(
        jax.random.PRNGKey(0), jb, valid=jb, params=jax.tree.map(jnp.asarray, p))
    model = params_from_jax(DIN(I, **kw, device="cpu"), p)
    got = Trainer(model, TrainConfig(**jcfg), device="cpu").fit(tb, valid=tb)
    for key, w in want.history.items():
        if key.split("_", 1)[1] in THRESHOLDED:
            np.testing.assert_array_equal(got.history[key].numpy(), w, err_msg=key)
        else:
            np.testing.assert_allclose(got.history[key].numpy(), w, rtol=1e-5, err_msg=key)
    want_params = _flat(want.params)
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=5e-5, err_msg=k)

    window = np.random.default_rng(2).integers(0, I, (37, hist.shape[1])).astype(np.int32)
    jctx = JaxCtx(jnp.zeros((37, 24)), jnp.zeros((I, 19)), history=jnp.asarray(window))
    scores_want = JaxDIN(I, **kw).score_catalog(want.params, jctx)
    served = params_from_jax(DIN(I, **kw, device="cpu"), jax.tree.map(np.asarray, want.params))
    with torch.no_grad():
        scores = served.score_catalog(_ctx(37, history=torch.from_numpy(window)))
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_want), rtol=0, atol=1e-5)


def _nets(att_units, fc_units, d=D, bias=True):
    def net(d_in, units):
        dims = (d_in,) + tuple(units)
        return [dict({"w": torch.zeros(a, b)}, **({"b": torch.zeros(b)} if bias else {}))
                for a, b in zip(dims[:-1], dims[1:])]
    return net(3 * d, att_units), net(2 * d, fc_units)


ROUTE_CASES = {
    "preset": (((128, 64, 1), (256, 128, 1), 10, 64), True),
    "narrow": (((32, 16, 1), (64, 32, 1), 10, 16), True),
    "history_64": (((128, 64, 1), (256, 128, 1), 64, 64), True),
    "attention_depth_1": (((64, 1), (256, 128, 1), 10, 64), False),
    "attention_depth_3": (((64, 32, 16, 1), (256, 128, 1), 10, 64), False),
    "fc_depth_1": (((128, 64, 1), (256, 1), 10, 64), False),
    "fc_depth_3": (((128, 64, 1), (200, 80, 40, 1), 10, 64), False),
    "history_65": (((128, 64, 1), (256, 128, 1), 65, 64), False),
    "history_80": (((128, 64, 1), (256, 128, 1), 80, 64), False),
    "d_not_multiple_of_4": (((128, 64, 1), (256, 128, 1), 10, 6), False),
    "a1_not_multiple_of_4": (((30, 64, 1), (256, 128, 1), 10, 64), False),
    "a2_not_multiple_of_4": (((128, 10, 1), (256, 128, 1), 10, 64), False),
    "f1_not_multiple_of_4": (((128, 64, 1), (250, 128, 1), 10, 64), False),
    "f2_not_multiple_of_4": (((128, 64, 1), (256, 126, 1), 10, 64), False),
    "fc_wider_than_2048": (((128, 64, 1), (4096, 128, 1), 10, 64), False),
    "last_attention_width_2": (((128, 64, 2), (256, 128, 1), 10, 64), False),
    # the widths at which a tile of every launch fits (ops/cuda/din_head.py::fits)
    "fc_2048_2048": (((128, 64, 1), (2048, 2048, 1), 10, 64), True),
    "history_64_d_360": (((128, 64, 1), (256, 128, 1), 64, 360), True),
    "history_64_d_364_pool_too_wide": (((128, 64, 1), (256, 128, 1), 64, 364), False),
    "history_64_d_640_pool_too_wide": (((128, 64, 1), (256, 128, 1), 64, 640), False),
    "history_64_d_1024_no_tile_fits": (((128, 64, 1), (256, 128, 1), 64, 1024), False),
    "history_10_d_1024_pool_too_wide": (((128, 64, 1), (256, 128, 1), 10, 1024), False),
}


# (L, D, F, bits) at the preset's attention net as launches on an H100 showed
# them before the route took the fit into account: at L 64, D 1024 the
# forward, the backward and the window pool all raised; at D 512, 600 and 640
# the head launched and the window pool raised; at F (2048, 2048) the forward
# and the pool launched (the backward's fc weight gradients then raised, staged
# 16 rows at a time). Since the backward's split takes bf16 and the widest fc
# (SPLIT_BF16, 32; SPLIT_F32, 16, with a streamed fc head where the float32 fc
# head's tile does not fit), D 512 to 640 at L 64 take the bf16 split and F
# (2048, 2048) both (tests/test_torch_cuda_kernels.py holds the bits against
# the library's din_head_fits on the card).
CARD_FITS = [(64, 1024, (256, 128), 0), (64, 512, (256, 128), 35), (64, 600, (256, 128), 35),
             (64, 640, (256, 128), 35), (10, 64, (2048, 2048), 63)]


@pytest.mark.parametrize("L,D,F,bits", CARD_FITS)
def test_fit_mirror_matches_the_cards_launches(L, D, F, bits):
    from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as cuda_dh

    assert cuda_dh.fits(L, D, 128, 64, *F) == bits


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_kernel_route_from_shapes(case):
    from deeplearningrecommendationsystem_tpu_torch.ops.din_head import kernel_route

    (att_units, fc_units, hist_len, d), want = ROUTE_CASES[case]
    att, fc = _nets(att_units, fc_units, d)
    assert kernel_route(att, fc, hist_len, d) is want


def test_kernel_route_needs_attention_biases():
    from deeplearningrecommendationsystem_tpu_torch.ops.din_head import kernel_route

    att, fc = _nets((128, 64, 1), (256, 128, 1), 64, bias=False)
    assert kernel_route(att, fc, 10, 64) is False
