"""The port's NeuralCF and AutoRec against the JAX package's, on the same
NumPy inputs and weights (``params_from_jax``), at small widths: NeuralCF 30
users, 70 items, mf_dim 16, layers (32, 16, 8); AutoRec hidden 12 over a
30 x 70 rating matrix of 1, 0 and 0.5, user-major (U-AutoRec, num_input 70)
and item-major (I-AutoRec, num_input 30).

* logits and parameter gradients (rtol 1e-5 / atol 1e-6; gradients rtol
  1e-4, atol 1e-6: float32 sums in another order), AutoRec's under the
  weighted loss (entries of 0.5 weigh 0);
* ``catalog_scores_from_pairs`` (64-user tiles, ids padded by ``% U``) and
  AutoRec's ``score_catalog`` in both orientations against JAX's (atol 1e-5),
  the I-AutoRec catalog [U, I] after its transpose;
* three Trainer epochs against the JAX ``Trainer`` (losses rtol 1e-5,
  thresholded metrics exactly, params atol 5e-5, the checksum atol 2e-4 as in
  ``tests/test_torch_experiments.py``), AutoRec in the weighted
  mode, and NeuralCF under bfloat16 compute with XLA's excess precision off
  for the JAX run (as ``tests/test_torch_feature_models.py``): the forward is
  bit for bit, autograd's bf16 backward sums in another order than JAX's VJP,
  and Adam turns a near-zero gradient of flipped sign into a step of lr.
  Measured (lr 5e-3): losses within 2.0e-6 relative, params' median gap
  1.2e-7, 14 of 4,041 past 5e-4, the largest 1.2e-2. Held to the DIEN test's
  bf16 limits (``tests/test_torch_dien.py::check_bf16_run``: losses rtol
  5e-5, at most 1% of the params past 5e-4, every param within 2 x epochs x
  lr, here 3e-2).
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.models import AutoRec as JaxAutoRec
from deeplearningrecommendationsystem_tpu.models import NeuralCF as JaxNeuralCF
from deeplearningrecommendationsystem_tpu.models.base import ServingContext as JaxCtx
from deeplearningrecommendationsystem_tpu.models.base import (
    catalog_scores_from_pairs as jax_from_pairs,
)
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu_torch.models import AutoRec, NeuralCF, ServingContext
from deeplearningrecommendationsystem_tpu_torch.models.base import catalog_scores_from_pairs
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

from test_torch_dien import THRESHOLDED, _flat, check_bf16_run


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

U, I, N = 30, 70, 256
NCF_KW = {"mf_dim": 16, "layers": (32, 16, 8)}
HIDDEN = 12


def _jnp(p):
    return jax.tree.map(jnp.asarray, p)


def _ncf(seed=0):
    params = jax.tree.map(np.asarray, JaxNeuralCF(U, I, **NCF_KW).init(jax.random.PRNGKey(seed)))
    return params, params_from_jax(NeuralCF(U, I, **NCF_KW, device="cpu"), params)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    return (rng.integers(0, U, N).astype(np.int32), rng.integers(0, I, N).astype(np.int32),
            (rng.random(N) < 0.4).astype(np.float32))


def _matrix(item_major, seed=1):
    rng = np.random.default_rng(seed)
    m = np.full((U, I), 0.5, np.float32)
    m[rng.random((U, I)) < 0.15] = 0.0
    m[rng.random((U, I)) < 0.1] = 1.0
    return m.T.copy() if item_major else m


def _autorec(item_major, seed=0):
    n = U if item_major else I
    params = jax.tree.map(np.asarray, JaxAutoRec(n, HIDDEN).init(jax.random.PRNGKey(seed)))
    return params, params_from_jax(AutoRec(n, HIDDEN, device="cpu"), params)


def _check_grads(model, g_want):
    g_want = _flat(g_want)
    named = dict(model.named_parameters())
    assert named.keys() == g_want.keys()
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), g_want[k], rtol=1e-4, atol=1e-6, err_msg=k)


def test_neuralcf_apply_and_grads_match_jax(pairs):
    users, items, y = pairs
    params, model = _ncf()

    def jax_loss(p):
        lg = JaxNeuralCF(U, I, **NCF_KW).apply(p, (jnp.asarray(users), jnp.asarray(items)))
        return jnp.mean(jnp.maximum(lg, 0) - lg * y + jnp.log1p(jnp.exp(-jnp.abs(lg)))), lg

    (_, lg_want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(_jnp(params))
    lg = model((torch.from_numpy(users), torch.from_numpy(items)))
    torch.nn.functional.binary_cross_entropy_with_logits(lg, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(lg_want), rtol=1e-5, atol=1e-6)
    _check_grads(model, g_want)
    assert {k: tuple(v.shape) for k, v in model.named_parameters()
            if "mlp" in k and "." not in k[4:]} == {"mlp_user": (U, 16), "mlp_item": (I, 16)}


@pytest.mark.parametrize("num_users", [U, 70], ids=["users_30", "users_70"])
def test_catalog_scores_from_pairs_match_jax(num_users):
    """One short tile (30 users, padded to 64) and two (70 users, the second
    padded by users 0-57 again)."""
    params = jax.tree.map(np.asarray, JaxNeuralCF(num_users, I, **NCF_KW).init(
        jax.random.PRNGKey(3)))
    model = params_from_jax(NeuralCF(num_users, I, **NCF_KW, device="cpu"), params)
    want = jax_from_pairs(JaxNeuralCF(num_users, I, **NCF_KW).apply, _jnp(params), num_users, I)
    with torch.no_grad():
        got = catalog_scores_from_pairs(model.apply_params, model.params(), num_users, I, "cpu")
        served = model.score_catalog(ServingContext(torch.zeros((num_users, 24)),
                                                    torch.zeros((I, 19))))
    assert got.shape == (num_users, I)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert torch.equal(served, got)


@pytest.mark.parametrize("item_major", [False, True], ids=["u_autorec", "i_autorec"])
def test_autorec_apply_and_weighted_grads_match_jax(item_major):
    m = _matrix(item_major)
    w = (m != 0.5).astype(np.float32)
    params, model = _autorec(item_major)

    def jax_loss(p):
        lg = JaxAutoRec(m.shape[1], HIDDEN).apply(p, jnp.asarray(m))
        losses = jnp.maximum(lg, 0) - lg * m + jnp.log1p(jnp.exp(-jnp.abs(lg)))
        return jnp.sum(losses * w) / jnp.maximum(jnp.sum(w), 1.0), lg

    (v_want, lg_want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(_jnp(params))
    x = torch.from_numpy(m)
    lg = model(x)
    losses = torch.nn.functional.binary_cross_entropy_with_logits(lg, x, reduction="none")
    loss = (losses * torch.from_numpy(w)).sum() / torch.from_numpy(w).sum().clamp_min(1.0)
    loss.backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(lg_want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(v_want), rtol=1e-5)
    _check_grads(model, g_want)


@pytest.mark.parametrize("item_major", [False, True], ids=["u_autorec", "i_autorec"])
def test_autorec_score_catalog_matches_jax(item_major):
    """[U, I] in both orientations: I-AutoRec scores the [I, U] matrix and
    transposes back."""
    m = _matrix(item_major)
    params, model = _autorec(item_major)
    want = JaxAutoRec(m.shape[1], HIDDEN).score_catalog(
        _jnp(params), JaxCtx(jnp.zeros((U, 24)), jnp.zeros((I, 19)), rating_matrix=jnp.asarray(m)))
    ctx = ServingContext(torch.zeros((U, 24)), torch.zeros((I, 19)),
                         rating_matrix=torch.from_numpy(m))
    with torch.no_grad():
        got = model.score_catalog(ctx)
    assert got.shape == (U, I)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert torch.equal(ctx.to(torch.device("cpu")).rating_matrix, ctx.rating_matrix)
    with pytest.raises(ValueError, match="rating_matrix"):
        model.score_catalog(ServingContext(torch.zeros((U, 24)), torch.zeros((I, 19))))


def _check_history(got, want):
    assert set(got.history) == set(want.history)
    for key, w in want.history.items():
        metric = key.split("_", 1)[1]
        if key == "_param_checksum":  # a sum of thousands of values near -0.4
            np.testing.assert_allclose(got.history[key].numpy(), w, atol=2e-4, err_msg=key)
        elif metric in THRESHOLDED:
            np.testing.assert_array_equal(got.history[key].numpy(), w, err_msg=key)
        else:
            np.testing.assert_allclose(got.history[key].numpy(), w, rtol=1e-5, err_msg=key)
    for key in want.extras:
        np.testing.assert_allclose(got.extras[key], want.extras[key], rtol=1e-5, err_msg=key)
    want_params = _flat(want.params)
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=5e-5, err_msg=k)


CFG = dict(learning_rate=5e-3, weight_decay=1e-5, epochs=3)


def test_neuralcf_trainer_matches_jax(pairs):
    users, items, y = pairs
    params, model = _ncf()
    jb = ((jnp.asarray(users), jnp.asarray(items)), jnp.asarray(y))
    want = JaxTrainer(JaxNeuralCF(U, I, **NCF_KW), JaxConfig(**CFG)).fit(
        jax.random.PRNGKey(0), jb, valid=jb, test=jb, params=_jnp(params))
    tb = ((torch.from_numpy(users), torch.from_numpy(items)), torch.from_numpy(y))
    got = Trainer(model, TrainConfig(**CFG), device="cpu").fit(tb, valid=tb, test=tb)
    _check_history(got, want)


@pytest.mark.parametrize("item_major", [False, True], ids=["u_autorec", "i_autorec"])
def test_autorec_weighted_trainer_matches_jax(item_major):
    """The matrix family's masked mode: rows split 18/6/6, each with its own
    weights (entries not 0.5)."""
    m = _matrix(item_major)
    params, model = _autorec(item_major)
    rows = np.split(np.random.default_rng(2).permutation(m.shape[0]), [m.shape[0] * 3 // 5,
                                                                      m.shape[0] * 4 // 5])
    splits = {name: m[r] for name, r in zip(("train", "valid", "test"), rows)}
    jw = {k: jnp.asarray((v != 0.5).astype(np.float32)) for k, v in splits.items()}
    tw = {k: torch.from_numpy((v != 0.5).astype(np.float32)) for k, v in splits.items()}
    jb = {k: (jnp.asarray(v), jnp.asarray(v)) for k, v in splits.items()}
    tb = {k: (torch.from_numpy(v), torch.from_numpy(v)) for k, v in splits.items()}
    want = JaxTrainer(JaxAutoRec(m.shape[1], HIDDEN), JaxConfig(**CFG)).fit(
        jax.random.PRNGKey(0), jb["train"], valid=jb["valid"], test=jb["test"], weights=jw,
        params=_jnp(params))
    got = Trainer(model, TrainConfig(**CFG), device="cpu").fit(
        tb["train"], valid=tb["valid"], test=tb["test"], weights=tw)
    _check_history(got, want)


def test_neuralcf_trainer_bfloat16_matches_jax(pairs, monkeypatch):
    import deeplearningrecommendationsystem_tpu.train.trainer as jax_trainer

    exact_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
    monkeypatch.setattr(jax_trainer, "jax",
                        types.SimpleNamespace(**{**vars(jax), "jit": exact_jit}))
    users, items, y = pairs
    params, model = _ncf()
    cfg = dict(CFG, compute_dtype="bfloat16")
    jb = ((jnp.asarray(users), jnp.asarray(items)), jnp.asarray(y))
    want = JaxTrainer(JaxNeuralCF(U, I, **NCF_KW), JaxConfig(**cfg)).fit(
        jax.random.PRNGKey(0), jb, valid=jb, test=jb, params=_jnp(params))
    tb = ((torch.from_numpy(users), torch.from_numpy(items)), torch.from_numpy(y))
    got = Trainer(model, TrainConfig(**cfg), device="cpu").fit(tb, valid=tb, test=tb)
    check_bf16_run(got, want, cfg)
