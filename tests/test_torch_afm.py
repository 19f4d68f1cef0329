"""The port's AFM and its attention pool against the JAX package, on the same
NumPy inputs and weights.

* the plain pool against ``afm_attention_pool_pallas`` in interpret mode
  (B = 70, F = 6, D = 32, A = 16; atol 2e-5, as ``tests/test_kernels.py``
  holds the Pallas kernel to the XLA pair);
* ``AfmAttentionPool``'s gradients against the Pallas custom VJP
  ``afm_attention_pool_fused`` (rtol 5e-4, atol 5e-5, the JAX test's); both
  also at (D, A) = (128, 128) and (64, 256) on 24 rows;
* AFM ``apply`` (rtol 1e-5) and its parameter gradients (rtol 1e-3,
  atol 1e-5, the JAX test's for its fused flag), and the catalog scores
  (atol 1e-5), at embedding 32 and attention 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.features import FeatureSpec as JaxSpec
from deeplearningrecommendationsystem_tpu.models import AFM as JaxAFM
from deeplearningrecommendationsystem_tpu.models.base import ServingContext as JaxCtx
from deeplearningrecommendationsystem_tpu.ops.pallas.afm_attention import (
    afm_attention_pool_fused,
    afm_attention_pool_pallas,
)
from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models import AFM, ServingContext
from deeplearningrecommendationsystem_tpu_torch.ops import afm_attention as afm_ops
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

B, F, D, A = 70, 6, 32, 16
U, I = 50, 80
SPEC, JAX_SPEC = FeatureSpec(num_users=U, num_items=I), JaxSpec(num_users=U, num_items=I)


@pytest.fixture(scope="module")
def pool_inputs():
    rng = np.random.default_rng(1)
    fields = rng.normal(size=(B, F, D)).astype(np.float32)
    w = rng.normal(size=(D, A)).astype(np.float32)
    b = rng.normal(size=A).astype(np.float32)
    h = rng.normal(size=(A, 1)).astype(np.float32)
    cot = rng.normal(size=(B, D)).astype(np.float32)
    return fields, w, b, h, cot


def test_plain_pool_matches_pallas(pool_inputs):
    fields, w, b, h, _ = pool_inputs
    want = afm_attention_pool_pallas(*map(jnp.asarray, (fields, w, b, h)), block_rows=16,
                                     interpret=True)
    args = [torch.from_numpy(a) for a in (fields, w, b, h)]
    got = afm_ops.afm_attention_pool_plain(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # the public wrapper takes the plain version on CPU tensors (equal to the last
    # bits: the CPU's threaded reductions may add in another order between calls)
    np.testing.assert_allclose(afm_ops.afm_attention_pool(*args).numpy(), got.numpy(),
                               rtol=1e-6, atol=1e-8)


def test_pool_grads_match_pallas_vjp(pool_inputs):
    fields, w, b, h, cot = pool_inputs

    def loss(f, w_, b_, h_):
        return jnp.sum(afm_attention_pool_fused(f, w_, b_, h_, 16, True) * cot)

    v_want, g_want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (fields, w, b, h)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (fields, w, b, h)]
    out = afm_ops.AfmAttentionPool.apply(*leaves)
    v_got = (out * torch.from_numpy(cot)).sum()
    v_got.backward()
    np.testing.assert_allclose(v_got.detach().item(), float(v_want), rtol=1e-5)
    for leaf, want in zip(leaves, g_want):
        assert leaf.grad.shape == leaf.shape and leaf.grad.dtype == torch.float32
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)
    # the backward wrapper returns the same, float32 (to the last bits: the CPU's
    # threaded reductions may add in another order from one call to the next)
    grads = afm_ops.afm_attention_pool_bwd(*[t.detach() for t in leaves], torch.from_numpy(cot))
    for got, leaf in zip(grads, leaves):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=1e-6, atol=1e-8)


def _features(rng, n):
    x = np.zeros((n, 45), np.float32)
    x[:, 0] = rng.integers(0, U, n)
    x[:, 1] = rng.integers(0, I, n)
    x[:, 2] = rng.random(n)
    x[np.arange(n), 3 + rng.integers(0, 2, n)] = 1
    x[np.arange(n), 5 + rng.integers(0, 21, n)] = 1
    x[:, 26:] = rng.random((n, 19)) < 0.2
    return x


@pytest.fixture(scope="module")
def model_inputs():
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, JaxAFM(JAX_SPEC, 32, 16).init(jax.random.PRNGKey(0)))
    x = _features(rng, 40)
    y = (rng.random(40) < 0.5).astype(np.float32)
    return params, x, y


def _bce(lg, y):
    return (lg.clamp_min(0) - lg * y + torch.log1p(torch.exp(-lg.abs()))).mean()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


@pytest.mark.parametrize("flags", [{}, {"fused_attention": True, "pallas_serving": True}],
                         ids=["default", "jax_kernel_flags"])
def test_apply_and_grads_match_jax(model_inputs, flags):
    params, x, y = model_inputs
    jmodel = JaxAFM(JAX_SPEC, 32, 16)

    def jax_loss(p):
        lg = jmodel.apply(p, jnp.asarray(x))
        return jnp.mean(jnp.maximum(lg, 0) - lg * y + jnp.log1p(jnp.exp(-jnp.abs(lg)))), lg

    (v_want, lg_want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    model = params_from_jax(AFM(SPEC, 32, 16, device="cpu", **flags), params)
    lg = model(torch.from_numpy(x))
    loss = _bce(lg, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(lg.detach().numpy(), np.asarray(lg_want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.detach().item(), float(v_want), rtol=1e-5)
    g_want = _flat(jax.tree.map(np.asarray, g_want))
    named = dict(model.named_parameters())
    assert named.keys() == g_want.keys()
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), g_want[k], rtol=1e-3, atol=1e-5, err_msg=k)


def test_parameters_and_init(model_inputs):
    model = AFM(SPEC, 32, 16, generator=torch.Generator().manual_seed(0), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert shapes == {k: v.shape for k, v in _flat(model_inputs[0]).items()}
    # the attention parameters are standard normal, as in the reference
    assert 0.8 < float(model.att_w.detach().std()) < 1.2


def test_catalog_scores_match_jax(model_inputs):
    params, _, _ = model_inputs
    rng = np.random.default_rng(2)
    uf = np.concatenate([rng.random((U, 1)), np.eye(2)[rng.integers(0, 2, U)],
                         np.eye(21)[rng.integers(0, 21, U)]], 1).astype(np.float32)
    itf = (rng.random((I, 19)) < 0.2).astype(np.float32)
    want = JaxAFM(JAX_SPEC, 32, 16).score_catalog(jax.tree.map(jnp.asarray, params),
                                                  JaxCtx(jnp.asarray(uf), jnp.asarray(itf)))
    model = params_from_jax(AFM(SPEC, 32, 16, device="cpu"), params)
    with torch.no_grad():
        got = model.score_catalog(ServingContext(torch.from_numpy(uf), torch.from_numpy(itf)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["lr", "afm"])
def test_resume_from_jax_state(model_inputs, name):
    """Both packages' Trainer trains 2 epochs; the port then resumes from the JAX
    params and optax Adam state (``params_from_jax``, ``opt_state_from_jax``:
    the nested ``wide``, ``att_out`` and ``tables`` dicts) for 2 more, against
    the JAX trainer's own resume: losses rtol 1e-5, params atol 1e-5."""
    from deeplearningrecommendationsystem_tpu.models import LogisticRegression as JaxLR
    from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
    from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
    from deeplearningrecommendationsystem_tpu_torch.models import LogisticRegression
    from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
    from deeplearningrecommendationsystem_tpu_torch.weights import opt_state_from_jax

    _, x, y = model_inputs
    jmodel = JaxLR(JAX_SPEC) if name == "lr" else JaxAFM(JAX_SPEC, 32, 16)
    params = jmodel.init(jax.random.PRNGKey(4))

    def jax_fit(p, opt_state=None):
        tr = JaxTrainer(jmodel, JaxConfig(learning_rate=0.01, epochs=2, track_metrics=False))
        return tr.fit(jax.random.PRNGKey(0), (jnp.asarray(x), jnp.asarray(y)), params=p,
                      opt_state=opt_state)

    first = jax_fit(params)
    want = jax_fit(first.params, first.opt_state)
    model = LogisticRegression(SPEC, device="cpu") if name == "lr" else AFM(SPEC, 32, 16,
                                                                            device="cpu")
    params_from_jax(model, jax.tree.map(np.asarray, first.params))
    state = opt_state_from_jax(model, first.opt_state)
    assert state.keys() == dict(model.named_parameters()).keys()
    assert all(float(st["step"]) == 2.0 for st in state.values())
    got = Trainer(model, TrainConfig(learning_rate=0.01, epochs=2, track_metrics=False),
                  device="cpu").fit((torch.from_numpy(x), torch.from_numpy(y)), opt_state=state)
    np.testing.assert_allclose(got.history["train_loss"].numpy(),
                               np.asarray(want.history["train_loss"]), rtol=1e-5)
    want_params = _flat(jax.tree.map(np.asarray, want.params))
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=1e-5, err_msg=k)


def test_weights_refuse_unknown_models_and_names(model_inputs):
    from torch import nn

    with pytest.raises(TypeError, match="no JAX weight mapping"):
        params_from_jax(nn.Linear(2, 2), {"weight": np.zeros((2, 2))})
    params = dict(model_inputs[0], extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra"):
        params_from_jax(AFM(SPEC, 32, 16, device="cpu"), params)


# widths the CUDA kernels take with their weights in device memory: the
# preset's D at A 128, and A past 128; the same checks as above at a small batch
WIDE = [(128, 128), (64, 256)]


@pytest.mark.parametrize("width,att", WIDE)
def test_plain_pool_and_grads_match_pallas_at_wide_widths(width, att):
    rng = np.random.default_rng(width + att)
    n = 24
    fields = (0.3 * rng.normal(size=(n, F, width))).astype(np.float32)
    w = (rng.normal(size=(width, att)) / np.sqrt(width)).astype(np.float32)
    b = rng.normal(size=att).astype(np.float32)
    h = (rng.normal(size=(att, 1)) / np.sqrt(att)).astype(np.float32)
    cot = rng.normal(size=(n, width)).astype(np.float32)
    want = afm_attention_pool_pallas(*map(jnp.asarray, (fields, w, b, h)), block_rows=8,
                                     interpret=True)
    args = [torch.from_numpy(a) for a in (fields, w, b, h)]
    np.testing.assert_allclose(afm_ops.afm_attention_pool(*args).numpy(), np.asarray(want), atol=2e-5)

    def loss(f, w_, b_, h_):
        return jnp.sum(afm_attention_pool_fused(f, w_, b_, h_, 8, True) * cot)

    g_want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (fields, w, b, h)))
    grads = afm_ops.afm_attention_pool_bwd(*args, torch.from_numpy(cot))
    for got, want_g, leaf in zip(grads, g_want, args):
        assert got.shape == leaf.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want_g), rtol=5e-4, atol=5e-5)
