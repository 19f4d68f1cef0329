"""The port's DIEN against the JAX package's, on the same NumPy inputs and
weights (``params_from_jax``), at a small width: 200 items, D 8, attention
(16, 8, 1), fc (32, 16, 1), L 10, in parity mode (one GRU over the
attention-scaled history) and with ``use_augru`` (the extractor GRU and the
AUGRU).

* ``apply_params`` and the parameter gradients against JAX ``DIEN.apply``
  (logits rtol 1e-5, atol 1e-6; gradients rtol 1e-3, atol 1e-5, as the DIN
  tests: float32 sums through ten GRU steps in another order);
* ``apply_full`` on right-padded histories, lengths 1 to L, so that some end
  mid-bucket (atol 1e-6), and ``apply_with_aux`` and ``auxiliary_loss``
  (rtol 1e-5);
* the ``indirect_hist`` batch against the direct one: the same logits bit
  for bit, gradients up to the order of the table sums (rtol 2e-5);
* the window and full-history catalogs against JAX's ``score_catalog``
  (atol 1e-5), the latter at two bucket sets;
* three Trainer epochs against the JAX ``Trainer``: plain, with
  ``aux_loss_fn="model"`` and with a callable (losses rtol 1e-5, params atol
  5e-5), and under bfloat16 compute with XLA's excess precision off for the
  JAX run, as ``tests/test_torch_feature_models.py`` states it. There the
  forward is the JAX forward bit for bit (the GRU's sigmoid and the
  attention's softmax take the JAX lowerings under bf16), but autograd's
  bf16 backward sums in another order than JAX's VJP (bias gradients up to 4
  bf16 ulps apart), and Adam's normalised step turns a gradient near 0 whose
  sign flips into a step of lr the other way. Measured over both modes, with
  and without the auxiliary loss: losses within 1.6e-5 relative, params'
  median gap 1e-7, at most 13 of 4,098 params past 5e-4, the largest 3.8e-3.
  Held to: losses rtol 5e-5; at most 1% of the params past 5e-4; every param
  within 2 x epochs x lr (6e-3), the most that steps of opposite sign move it.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.models import DIEN as JaxDIEN
from deeplearningrecommendationsystem_tpu.models.base import ServingContext as JaxCtx
from deeplearningrecommendationsystem_tpu.models.base import (
    catalog_scores_full_history as jax_full_history,
)
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu_torch.models import DIEN, ServingContext
from deeplearningrecommendationsystem_tpu_torch.models.base import catalog_scores_full_history
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: these tests run many small ops (DIEN's GRU
    steps), for which threads buy nothing alone and, with several test
    workers on one host, each worker's thread pool spinning against the
    others' made them ten times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

I, D, L, B = 200, 8, 10, 48
KW = {"embed_size": D, "attention_units": (16, 8, 1), "fc_units": (32, 16, 1)}
MODES = {"parity": {}, "augru": {"use_augru": True}}
THRESHOLDED = ("accuracy", "precision", "recall", "f1", "auc")


def _flat(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        nested = isinstance(v, (dict, list, tuple))
        out.update(_flat(v, f"{prefix}{k}.") if nested else {f"{prefix}{k}": np.asarray(v)})
    return out


def _params(mode, seed=0):
    return jax.tree.map(np.asarray, JaxDIEN(I, **KW, **MODES[mode]).init(jax.random.PRNGKey(seed)))


def _port(mode, params, **flags):
    return params_from_jax(DIEN(I, **KW, **MODES[mode], **flags, device="cpu"), params)


def _jnp(p):
    return jax.tree.map(jnp.asarray, p)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    hist = rng.integers(0, I, (B, L))
    target = rng.integers(0, I, B)
    neg = rng.integers(0, I, (B, L))
    y = (rng.random(B) < 0.5).astype(np.float32)
    return hist, target, neg, y


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_and_grads_match_jax(batch, mode):
    hist, target, _, y = batch
    params = _params(mode)
    jmodel = JaxDIEN(I, **KW, **MODES[mode])

    def jax_loss(p):
        lg = jmodel.apply(p, (jnp.asarray(hist), jnp.asarray(target)))
        return jnp.mean(jnp.maximum(lg, 0) - lg * y + jnp.log1p(jnp.exp(-jnp.abs(lg)))), lg

    (_, lg_want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(_jnp(params))
    model = _port(mode, params)
    lg = model(_t(hist, target))
    torch.nn.functional.binary_cross_entropy_with_logits(lg, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(lg_want), rtol=1e-5, atol=1e-6)
    g_want = _flat(g_want)
    named = dict(model.named_parameters())
    assert named.keys() == g_want.keys()
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), g_want[k], rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_full_matches_jax(mode):
    """Right-padded histories of 1 to 24 steps in a bucket of 24: the state is
    read at each row's own last step (the AUGRU's held past it)."""
    rng = np.random.default_rng(2)
    hist = rng.integers(0, I, (B, 24))
    target = rng.integers(0, I, B)
    length = rng.integers(1, 25, B)
    length[:3] = (1, 13, 24)
    params = _params(mode)
    want = JaxDIEN(I, **KW, **MODES[mode]).apply_full(
        _jnp(params), tuple(map(jnp.asarray, (hist, target, length))))
    model = _port(mode, params)
    with torch.no_grad():
        got = model.apply_full(model.params(), _t(hist, target, length))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_apply_with_aux_and_auxiliary_loss_match_jax(batch, mode):
    hist, target, neg, _ = batch
    params = _params(mode)
    jmodel, model = JaxDIEN(I, **KW, **MODES[mode]), _port(mode, params)
    lg_want, aux_want = jmodel.apply_with_aux(_jnp(params), tuple(map(jnp.asarray,
                                                                       (hist, target, neg))))
    with torch.no_grad():
        lg, aux = model.apply_with_aux(model.params(), _t(hist, target, neg))
        # a trailing neg_hist leaves the logits as they are
        np.testing.assert_array_equal(model(_t(hist, target, neg)).numpy(),
                                      model(_t(hist, target)).numpy())
        alone = model.auxiliary_loss(model.params(), *_t(hist, neg))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lg_want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(aux_want), rtol=1e-5)
    want = jmodel.auxiliary_loss(_jnp(params), jnp.asarray(hist), jnp.asarray(neg))
    np.testing.assert_allclose(alone.item(), float(want), rtol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
def test_indirect_hist_equals_the_direct_batch(mode):
    rng = np.random.default_rng(1)
    U = 12
    hist_u, uidx, target = _t(rng.integers(0, I, (U, L)), rng.integers(0, U, B),
                              rng.integers(0, I, B))
    neg = torch.from_numpy(rng.integers(0, I, (B, L)))
    cot = torch.from_numpy(rng.normal(size=B).astype(np.float32))
    params = _params(mode)
    std, ind = _port(mode, params), _port(mode, params, indirect_hist=True)
    out_std, out_ind = std((hist_u[uidx], target)), ind((hist_u, uidx, target))
    np.testing.assert_array_equal(out_std.detach().numpy(), out_ind.detach().numpy())
    (out_std * cot).sum().backward()
    (out_ind * cot).sum().backward()
    for (k, a), b in zip(std.named_parameters(), ind.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=2e-5, atol=1e-6, err_msg=k)
    with torch.no_grad():  # the auxiliary loss of the indirect batch, neg_hist last
        lg_s, aux_s = std.apply_with_aux(std.params(), (hist_u[uidx], target, neg))
        lg_i, aux_i = ind.apply_with_aux(ind.params(), (hist_u, uidx, target, neg))
    assert torch.equal(lg_s, lg_i) and torch.equal(aux_s, aux_i)


def _ctx(U, **kw):
    return ServingContext(torch.zeros((U, 24)), torch.zeros((I, 19)), **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_window_catalog_scores_match_jax(mode):
    """``ctx.history``: 8-user tiles, 13 users so that the last tile is short."""
    U = 13
    history = np.random.default_rng(3).integers(0, I, (U, L)).astype(np.int32)
    params = _params(mode)
    want = JaxDIEN(I, **KW, **MODES[mode]).score_catalog(
        _jnp(params), JaxCtx(jnp.zeros((U, 24)), jnp.zeros((I, 19)), history=jnp.asarray(history)))
    with torch.no_grad():
        got = _port(mode, params).score_catalog(_ctx(U, history=torch.from_numpy(history)))
    assert got.shape == (U, I)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="ctx.history"):
        _port(mode, params).score_catalog(_ctx(U))


def _histories(U, seed, max_len):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, I, rng.integers(1, max_len + 1)).astype(np.int32) for _ in range(U)]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("buckets", [(8, 16, 32), (20,)], ids=["buckets_8_16_32", "bucket_20"])
def test_full_history_scores_match_jax(mode, buckets):
    """Users of 1 to 20 steps, most ending inside their bucket; through
    ``score_catalog`` (embedded once) and the plain scorer, against JAX."""
    histories = _histories(9, seed=4, max_len=20)
    params = _params(mode)
    jmodel, model = JaxDIEN(I, **KW, **MODES[mode]), _port(mode, params)
    jp = _jnp(params)
    want = jax_full_history(jmodel.apply_full, jp, histories, I, buckets=buckets)
    with torch.no_grad():
        got = catalog_scores_full_history(model.apply_full, model.params(), histories, I, "cpu",
                                          buckets=buckets)
        embedded = catalog_scores_full_history(
            model.apply_full, model.params(), histories, I, "cpu", buckets=buckets,
            embed_fn=lambda p, h: model.item[h], apply_embedded_fn=model.apply_full_embedded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(embedded.numpy(), got.numpy(), rtol=0, atol=1e-6)
    if buckets == (20,):  # score_catalog dispatches on ctx.full_histories
        with torch.no_grad():
            served = model.score_catalog(_ctx(9, full_histories=histories))
        want = jmodel.score_catalog(jp, JaxCtx(jnp.zeros((9, 24)), jnp.zeros((I, 19)),
                                               full_histories=histories))
        np.testing.assert_allclose(served.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _aux_callable(jax_side):
    """The same auxiliary term in each package: 1e-3 times the item table's
    mean square."""
    if jax_side:
        return lambda p, b: 1e-3 * jnp.mean(p["item"] ** 2)
    return lambda p, b: 1e-3 * torch.mean(p["item"] ** 2)


TRAINER_CASES = {
    "parity": ("parity", {}),
    "augru_aux_model": ("augru", {"aux_loss_fn": "model", "aux_weight": 0.5}),
    "parity_aux_model": ("parity", {"aux_loss_fn": "model", "aux_weight": 0.5}),
    "parity_aux_callable": ("parity", {"aux_loss_fn": "callable", "aux_weight": 2.0}),
}


def _check_history(got, want, params_tol):
    assert set(got.history) == set(want.history)
    for key, w in want.history.items():
        metric = key.split("_", 1)[1]
        if metric in THRESHOLDED:
            np.testing.assert_array_equal(got.history[key].numpy(), w, err_msg=key)
        else:
            np.testing.assert_allclose(got.history[key].numpy(), w, rtol=1e-5, err_msg=key)
    want_params = _flat(want.params)
    for k, v in got.params.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=params_tol, err_msg=k)


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_trainer_matches_jax(batch, case):
    mode, aux = TRAINER_CASES[case]
    hist, target, neg, y = batch
    train = (hist, target, neg) if aux.get("aux_loss_fn") == "model" else (hist, target)
    jkw = dict(aux)
    tkw = dict(aux)
    if aux.get("aux_loss_fn") == "callable":
        jkw["aux_loss_fn"], tkw["aux_loss_fn"] = _aux_callable(True), _aux_callable(False)
    params = _params(mode)
    cfg = dict(learning_rate=1e-3, weight_decay=1e-5, epochs=3)
    jb = (tuple(map(jnp.asarray, train)), jnp.asarray(y))
    jv = ((jnp.asarray(hist), jnp.asarray(target)), jnp.asarray(y))
    want = JaxTrainer(JaxDIEN(I, **KW, **MODES[mode]), JaxConfig(**cfg), **jkw).fit(
        jax.random.PRNGKey(0), jb, valid=jv, test=jv, params=_jnp(params))
    tb = (_t(*train), torch.from_numpy(y))
    tv = (_t(hist, target), torch.from_numpy(y))
    got = Trainer(_port(mode, params), TrainConfig(**cfg), device="cpu", **tkw).fit(
        tb, valid=tv, test=tv)
    _check_history(got, want, 5e-5)
    if aux:  # the auxiliary term moved the loss
        plain = Trainer(_port(mode, params), TrainConfig(**cfg), device="cpu").fit(tb)
        assert not torch.equal(plain.history["train_loss"], got.history["train_loss"])


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_bfloat16_matches_jax(batch, mode, monkeypatch):
    """Three epochs under ``compute_dtype="bfloat16"`` with the auxiliary loss.
    The JAX run is compiled with ``xla_allow_excess_precision`` off, so that
    each bf16 op's result is rounded, as in the port."""
    import deeplearningrecommendationsystem_tpu.train.trainer as jax_trainer

    exact_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
    monkeypatch.setattr(jax_trainer, "jax",
                        types.SimpleNamespace(**{**vars(jax), "jit": exact_jit}))
    hist, target, neg, y = batch
    params = _params(mode)
    cfg = dict(learning_rate=1e-3, weight_decay=1e-5, epochs=3, compute_dtype="bfloat16")
    jb = ((jnp.asarray(hist), jnp.asarray(target), jnp.asarray(neg)), jnp.asarray(y))
    want = JaxTrainer(JaxDIEN(I, **KW, **MODES[mode]), JaxConfig(**cfg), aux_loss_fn="model",
                      aux_weight=0.5).fit(jax.random.PRNGKey(0), jb, valid=jb, test=jb,
                                          params=_jnp(params))
    tb = (_t(hist, target, neg), torch.from_numpy(y))
    got = Trainer(_port(mode, params), TrainConfig(**cfg), device="cpu", aux_loss_fn="model",
                  aux_weight=0.5).fit(tb, valid=tb, test=tb)
    check_bf16_run(got, want, cfg)


def check_bf16_run(got, want, cfg):
    """The bf16 limits of the module docstring."""
    for key in ("train_loss", "valid_loss", "test_loss"):
        np.testing.assert_allclose(got.history[key].numpy(), np.asarray(want.history[key]),
                                   rtol=5e-5, err_msg=key)
    want_params = _flat(want.params)
    gaps = []
    for k, v in got.params.items():
        assert v.dtype == torch.float32
        gaps.append(np.abs(v.numpy() - want_params[k]).ravel())
    gaps = np.concatenate(gaps)
    assert (gaps > 5e-4).mean() <= 0.01, f"{(gaps > 5e-4).sum()} of {gaps.size} params past 5e-4"
    assert gaps.max() <= 2 * cfg["epochs"] * cfg["learning_rate"], gaps.max()


def test_trainer_refuses_an_unknown_aux_mode():
    with pytest.raises(ValueError, match="aux_loss_fn"):
        Trainer(DIEN(I, **KW, device="cpu"), TrainConfig(), device="cpu", aux_loss_fn="fused")
