"""The port's DeepFM, WideDeep, NFM, PNN, DCN, DeepCrossing and FFM against the
JAX package, on the same NumPy inputs and weights (carried across with
``weights.py::params_from_jax``), at narrow widths: embeddings 8-16, towers
of two or three layers.

* ``apply`` (logits rtol 1e-5, atol 1e-6) and the parameter gradients of the
  BCE loss (rtol 1e-3, atol 1e-5), as ``tests/test_torch_afm.py`` holds AFM;
  PNN in both modes, DCN at 2 and 3 cross layers;
* the catalog scores (atol 1e-5);
* the parameter trees: the JAX init's names and shapes, FFM's dotted table
  keys included;
* ``params_from_jax`` and ``opt_state_from_jax``: the port resumes the JAX
  trainer's run from its params and Adam state (losses rtol 1e-5, params
  atol 1e-5, as ``tests/test_torch_afm.py``'s resume);
* ``robust_init`` starts the last tower bias at 0.1 (WideDeep, DeepFM, NFM);
* DeepFM and NFM trained under ``compute_dtype="bfloat16"`` with ``f32_fm`` /
  ``f32_cross`` on and off, at the DIN bf16 test's tolerances (losses rtol
  1e-5, params atol 5e-4). The ids here stay below 256, so the JAX trainer's
  cast of the whole feature matrix keeps them; the port keeps the matrix
  float32 and casts its dense columns where they meet the weights
  (``models/common.py::FeatureModel``).

The towers that end in ReLU(Linear(., 1)) are built with ``robust_init`` in
the gradient checks, so that their gradients are not all zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu import models as jax_models
from deeplearningrecommendationsystem_tpu.features import FeatureSpec as JaxSpec
from deeplearningrecommendationsystem_tpu.models.base import ServingContext as JaxCtx
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu_torch import models
from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models import ServingContext
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.weights import opt_state_from_jax, params_from_jax

U, I, B = 50, 80, 40
SPEC, JAX_SPEC = FeatureSpec(num_users=U, num_items=I), JaxSpec(num_users=U, num_items=I)
TOWER = (32, 16, 1)
# case -> (class name in both packages, constructor kwargs)
CASES = {
    "deepfm": ("DeepFM", {"hidden_units": TOWER, "embedding_dim": 16, "robust_init": True}),
    "widedeep": ("WideDeep", {"hidden_units": TOWER, "embedding_dim": 16, "robust_init": True}),
    "nfm": ("NFM", {"hidden_units": TOWER, "embedding_dim": 16, "robust_init": True}),
    "pnn_in": ("PNN", {"embedding_dim": 16, "hidden_units": (32, 16, 8), "mode": "in"}),
    "pnn_out": ("PNN", {"embedding_dim": 16, "hidden_units": (32, 16, 8), "mode": "out"}),
    "dcn_2": ("DCN", {"cross_layers": 2, "deep_hidden_units": TOWER, "embedding_dim": 8}),
    "dcn_3": ("DCN", {"cross_layers": 3, "deep_hidden_units": TOWER, "embedding_dim": 8}),
    "deepcrossing": ("DeepCrossing", {"embedding_dim": 8, "hidden_units": (32, 16)}),
    "ffm": ("FFM", {"num_vector": 8}),
}
# one case of each of the seven models
MODELS = ["deepfm", "widedeep", "nfm", "pnn_in", "dcn_3", "deepcrossing", "ffm"]


def _features(rng, n):
    x = np.zeros((n, 45), np.float32)
    x[:, 0] = rng.integers(0, U, n)
    x[:, 1] = rng.integers(0, I, n)
    x[:, 2] = rng.random(n)
    x[np.arange(n), 3 + rng.integers(0, 2, n)] = 1
    x[np.arange(n), 5 + rng.integers(0, 21, n)] = 1
    x[:, 26:] = rng.random((n, 19)) < 0.2
    return x


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, (list, tuple)):
            v = {str(i): layer for i, layer in enumerate(v)}
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _jax_model(case, **over):
    name, kw = CASES[case]
    return getattr(jax_models, name)(JAX_SPEC, **{**kw, **over})


def _port_model(case, **over):
    name, kw = CASES[case]
    return getattr(models, name)(SPEC, **{**kw, **over}, device="cpu")


def _jax_params(case, seed=0, **over):
    return jax.tree.map(np.asarray, _jax_model(case, **over).init(jax.random.PRNGKey(seed)))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    return _features(rng, B), (rng.random(B) < 0.5).astype(np.float32)


def _bce(lg, y):
    return (lg.clamp_min(0) - lg * y + torch.log1p(torch.exp(-lg.abs()))).mean()


@pytest.mark.parametrize("case", list(CASES))
def test_apply_and_grads_match_jax(batch, case):
    x, y = batch
    params = _jax_params(case)
    jmodel = _jax_model(case)

    def jax_loss(p):
        lg = jmodel.apply(p, jnp.asarray(x))
        return jnp.mean(jnp.maximum(lg, 0) - lg * y + jnp.log1p(jnp.exp(-jnp.abs(lg)))), lg

    (v_want, lg_want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model = params_from_jax(_port_model(case), params)
    lg = model(torch.from_numpy(x))
    loss = _bce(lg, torch.from_numpy(y))
    loss.backward()
    assert lg.shape == (B,) and lg.dtype == torch.float32
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(lg_want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(v_want), rtol=1e-5)
    g_want = _flat(jax.tree.map(np.asarray, g_want))
    named = dict(model.named_parameters())
    assert named.keys() == g_want.keys()
    tower = [g for k, g in g_want.items() if k.startswith(("deep.", "dnn.", "blocks."))]
    assert case == "ffm" or any(float(np.abs(g).max()) > 0 for g in tower)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), g_want[k], rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_parameters_match_the_jax_tree(case):
    """The port draws its own weights (a CPU generator), under the JAX init's
    names and shapes, float32."""
    want = {k: v.shape for k, v in _flat(_jax_params(case)).items()}
    model = _port_model(case, generator=torch.Generator().manual_seed(0))
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == want
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in model.parameters())
    again = _port_model(case, generator=torch.Generator().manual_seed(0))
    for (k, a), b in zip(model.named_parameters(), again.parameters()):
        assert torch.equal(a, b), k
    if case == "ffm":
        assert {"tables.user_id.user", "tables.item_id.item", "lr.wide.w"} <= got.keys()
    if case.startswith("dcn"):  # the cross biases start at zero
        assert all(not p.any() for k, p in model.named_parameters()
                   if k.startswith("cross.") and k.endswith(".b"))


@pytest.mark.parametrize("case", MODELS)
def test_catalog_scores_match_jax(case):
    params = _jax_params(case, seed=1)
    rng = np.random.default_rng(2)
    uf = np.concatenate([rng.random((U, 1)), np.eye(2)[rng.integers(0, 2, U)],
                         np.eye(21)[rng.integers(0, 21, U)]], 1).astype(np.float32)
    itf = (rng.random((I, 19)) < 0.2).astype(np.float32)
    want = _jax_model(case).score_catalog(jax.tree.map(jnp.asarray, params),
                                          JaxCtx(jnp.asarray(uf), jnp.asarray(itf)))
    model = params_from_jax(_port_model(case), params)
    with torch.no_grad():
        got = model.score_catalog(ServingContext(torch.from_numpy(uf), torch.from_numpy(itf)))
    assert got.shape == (U, I)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", MODELS)
def test_resume_from_jax_state(batch, case):
    """Both packages' Trainer trains 2 epochs; the port then resumes from the
    JAX params and optax Adam state for 2 more, against the JAX trainer's own
    resume."""
    x, y = batch
    jmodel = _jax_model(case)
    params = jmodel.init(jax.random.PRNGKey(4))

    def jax_fit(p, opt_state=None):
        tr = JaxTrainer(jmodel, JaxConfig(learning_rate=0.01, epochs=2, track_metrics=False))
        return tr.fit(jax.random.PRNGKey(0), (jnp.asarray(x), jnp.asarray(y)), params=p,
                      opt_state=opt_state)

    first = jax_fit(params)
    want = jax_fit(first.params, first.opt_state)
    model = params_from_jax(_port_model(case), jax.tree.map(np.asarray, first.params))
    state = opt_state_from_jax(model, first.opt_state)
    assert state.keys() == dict(model.named_parameters()).keys()
    assert all(float(st["step"]) == 2.0 for st in state.values())
    got = Trainer(model, TrainConfig(learning_rate=0.01, epochs=2, track_metrics=False),
                  device="cpu").fit((torch.from_numpy(x), torch.from_numpy(y)), opt_state=state)
    np.testing.assert_allclose(got.history["train_loss"].numpy(),
                               np.asarray(want.history["train_loss"]), rtol=1e-5)
    want_params = _flat(jax.tree.map(np.asarray, want.params))
    assert got.params.keys() == want_params.keys()
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", ["deepfm", "widedeep", "nfm"])
def test_robust_init_sets_the_last_tower_bias(case):
    for robust in (True, False):
        model = _port_model(case, robust_init=robust)
        last = model.deep[-1].b
        assert torch.equal(last, torch.full_like(last, 0.1)) == robust
        jax_last = _jax_params(case, robust_init=robust)["deep"][-1]["b"]
        assert bool(np.all(jax_last == np.float32(0.1))) == robust


BF16_CASES = {"deepfm_f32_fm": ("deepfm", {"f32_fm": True}),
              "deepfm_bf16_fm": ("deepfm", {"f32_fm": False}),
              "nfm_f32_cross": ("nfm", {"f32_cross": True}),
              "nfm_bf16_cross": ("nfm", {"f32_cross": False})}


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_trainer_bfloat16_matches_jax(batch, name, monkeypatch):
    """Three epochs under ``compute_dtype="bfloat16"``, the flag on and off:
    both packages round the same operands to bf16, but a sum in another order
    can land a value on the other bf16 neighbour, and Adam's normalised steps
    carry that: losses rtol 1e-5, params atol 5e-4, float32 master weights.

    The JAX trainer compiles the whole run, and XLA may then keep a bf16
    op's result in float32 for the next op (``xla_allow_excess_precision``,
    on by default); the port rounds every op's result, as the JAX ops do one
    by one. So the JAX run here is compiled with that option off. With it on,
    the gaps were up to 4.6e-4 in the losses and 3.8e-3 in the params (DeepFM
    without ``f32_fm``); with it off, 4.2e-7 and 3.7e-5."""
    import functools
    import types

    import deeplearningrecommendationsystem_tpu.train.trainer as jax_trainer

    exact_jit = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
    monkeypatch.setattr(jax_trainer, "jax", types.SimpleNamespace(**{**vars(jax), "jit": exact_jit}))
    case, flags = BF16_CASES[name]
    x, y = batch
    params = _jax_params(case, **flags)
    cfg = dict(learning_rate=1e-3, weight_decay=1e-5, epochs=3, compute_dtype="bfloat16")
    jb = (jnp.asarray(x), jnp.asarray(y))
    want = JaxTrainer(_jax_model(case, **flags), JaxConfig(**cfg)).fit(
        jax.random.PRNGKey(0), jb, valid=jb, test=jb, params=jax.tree.map(jnp.asarray, params))
    tb = (torch.from_numpy(x), torch.from_numpy(y))
    model = params_from_jax(_port_model(case, **flags), params)
    got = Trainer(model, TrainConfig(**cfg), device="cpu").fit(tb, valid=tb, test=tb)
    for key in ("train_loss", "valid_loss", "test_loss"):
        np.testing.assert_allclose(got.history[key].numpy(), np.asarray(want.history[key]),
                                   rtol=1e-5, err_msg=key)
    want_params = _flat(jax.tree.map(np.asarray, want.params))
    for k, v in got.params.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=5e-4, err_msg=k)


def test_pnn_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        _port_model("pnn_in", mode="outer")
