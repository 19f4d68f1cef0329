"""The feature family's shared code against the JAX package on the same NumPy
inputs and weights: ``linear``, ``embed_fields``, ``linear_part`` (forward and
gradients), each ``ops/interactions.py`` function, ``afm_attention`` and
``catalog_scores_from_features``.

Tolerances, float32 on the CPU: the ops are the same products and sums in
another library, rtol 1e-6 (atol 1e-6 where a value may be near zero);
the catalog scores atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.features import FeatureSpec as JaxSpec
from deeplearningrecommendationsystem_tpu.models import LogisticRegression as JaxLR
from deeplearningrecommendationsystem_tpu.models.base import ServingContext as JaxCtx
from deeplearningrecommendationsystem_tpu.models.base import (
    catalog_scores_from_features as jax_catalog_scores,
)
from deeplearningrecommendationsystem_tpu.models.common import linear_part as jax_linear_part
from deeplearningrecommendationsystem_tpu.ops import attention as jax_attention
from deeplearningrecommendationsystem_tpu.ops import interactions as jax_inter
from deeplearningrecommendationsystem_tpu.ops.embedding import embed_fields as jax_embed_fields
from deeplearningrecommendationsystem_tpu.ops.embedding import (
    init_field_tables as jax_init_field_tables,
)
from deeplearningrecommendationsystem_tpu.ops.linear import linear as jax_linear
from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models import LogisticRegression, ServingContext
from deeplearningrecommendationsystem_tpu_torch.models.base import catalog_scores_from_features
from deeplearningrecommendationsystem_tpu_torch.models.common import linear_part, nest
from deeplearningrecommendationsystem_tpu_torch.ops import attention, interactions
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import embed_fields, init_field_tables
from deeplearningrecommendationsystem_tpu_torch.ops.linear import linear, linear_init
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

U, I, B, D = 50, 80, 37, 16
SPEC, JAX_SPEC = FeatureSpec(num_users=U, num_items=I), JaxSpec(num_users=U, num_items=I)
TOL = {"rtol": 1e-6, "atol": 1e-6}


def features(rng, n, num_users=U, num_items=I):
    """[n, 45] float32 rows in the ml-100k layout: ids, age, one-hot gender and
    occupation, multi-hot genres."""
    x = np.zeros((n, 45), np.float32)
    x[:, 0] = rng.integers(0, num_users, n)
    x[:, 1] = rng.integers(0, num_items, n)
    x[:, 2] = rng.random(n)
    x[np.arange(n), 3 + rng.integers(0, 2, n)] = 1
    x[np.arange(n), 5 + rng.integers(0, 21, n)] = 1
    x[:, 26:] = rng.random((n, 19)) < 0.2
    return x


def _t(a):
    return torch.from_numpy(np.array(a))


def _grads_match(port_grads, jax_grads):
    assert port_grads.keys() == jax_grads.keys()
    for k in jax_grads:
        np.testing.assert_allclose(port_grads[k].numpy(), np.asarray(jax_grads[k]), err_msg=k,
                                   **TOL)


def test_linear_forward_and_grads():
    rng = np.random.default_rng(0)
    p = {"w": rng.normal(size=(43, 5)).astype(np.float32),
         "b": rng.normal(size=5).astype(np.float32)}
    x = rng.normal(size=(B, 43)).astype(np.float32)
    cot = rng.normal(size=(B, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda q: jax_linear(q, jnp.asarray(x)), jax.tree.map(jnp.asarray, p))
    tp = {k: _t(v).requires_grad_(True) for k, v in p.items()}
    got = linear(tp, _t(x))
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _grads_match({k: v.grad for k, v in tp.items()}, vjp(jnp.asarray(cot))[0])
    # no bias
    np.testing.assert_allclose(linear({"w": _t(p["w"])}, _t(x)).numpy(), x @ p["w"], **TOL)


def test_linear_init_bounds():
    p = linear_init(torch.Generator().manual_seed(0), 43, 7)
    bound = 1 / 43 ** 0.5
    assert p["w"].shape == (43, 7) and p["b"].shape == (7,)
    assert float(p["w"].abs().max()) <= bound and float(p["b"].abs().max()) <= bound
    assert float(p["w"].std()) > 0.4 * bound  # uniform on [-bound, bound]: std bound / sqrt(3)


def test_embed_fields_forward_and_grads():
    rng = np.random.default_rng(1)
    fields = ("user", "item", "age", "gender", "occupation", "genre")
    tables = {k: np.array(v) for k, v in
              jax_init_field_tables(jax.random.PRNGKey(0), JAX_SPEC, D, fields).items()}
    x = features(rng, B)
    cots = {k: rng.normal(size=(B, D)).astype(np.float32) for k in fields}

    def jax_loss(t):
        e = jax_embed_fields(t, jnp.asarray(x), JAX_SPEC)
        return sum(jnp.sum(e[k] * cots[k]) for k in fields), e

    (_, want), g_want = jax.value_and_grad(jax_loss, has_aux=True)(jax.tree.map(jnp.asarray, tables))
    tt = {k: _t(v).requires_grad_(True) for k, v in tables.items()}
    got = embed_fields(tt, _t(x), SPEC)
    sum((got[k] * _t(cots[k])).sum() for k in fields).backward()
    assert got.keys() == set(fields)
    for k in fields:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    _grads_match({k: v.grad for k, v in tt.items()}, g_want)
    # only the tables given are embedded
    assert embed_fields({"genre": tt["genre"]}, _t(x), SPEC).keys() == {"genre"}


def test_init_field_tables_shapes():
    tables = init_field_tables(torch.Generator().manual_seed(0), SPEC, D)
    assert {k: tuple(v.shape) for k, v in tables.items()} == {
        "user": (U, D), "item": (I, D), "gender": (2, D), "occupation": (21, D), "genre": (19, D)}


def test_linear_part_forward_and_grads():
    rng = np.random.default_rng(2)
    params = JaxLR(JAX_SPEC).init(jax.random.PRNGKey(1))
    x = features(rng, B)
    cot = rng.normal(size=(B, 1)).astype(np.float32)
    want, vjp = jax.vjp(lambda p: jax_linear_part(p, jnp.asarray(x), JAX_SPEC), params)
    model = params_from_jax(LogisticRegression(SPEC, device="cpu"),
                            jax.tree.map(np.asarray, params))
    flat = dict(model.named_parameters())
    got = linear_part(nest(flat), _t(x), SPEC, gather="any route")
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    g = vjp(jnp.asarray(cot))[0]
    _grads_match({k: p.grad for k, p in flat.items()},
                 {"user_bias": g["user_bias"], "item_bias": g["item_bias"],
                  "wide.w": g["wide"]["w"], "wide.b": g["wide"]["b"]})


def test_bf16_feature_matrix_raises():
    """Ids above 256 do not survive bfloat16: the feature family refuses it."""
    x = _t(features(np.random.default_rng(3), 4, num_users=943)).to(torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        SPEC.ids(x)


@pytest.mark.parametrize("name", ["fm_cross_term", "bi_interaction", "pairwise_products",
                                  "pairwise_inner_products"])
def test_interactions_match_jax(name):
    e = np.random.default_rng(4).normal(size=(B, 6, D)).astype(np.float32)
    got = getattr(interactions, name)(_t(e)).numpy()
    want = np.asarray(getattr(jax_inter, name)(jnp.asarray(e)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pair_order_is_the_references():
    e = torch.arange(4.0)[None, :, None] + 1.0  # fields 1, 2, 3, 4
    got = interactions.pairwise_products(e)[0, :, 0].tolist()
    assert got == [1 * 2, 1 * 3, 1 * 4, 2 * 3, 2 * 4, 3 * 4]


def test_afm_attention_matches_jax():
    rng = np.random.default_rng(5)
    cross = rng.normal(size=(B, 15, D)).astype(np.float32)
    w = rng.normal(size=(D, 8)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    h = rng.normal(size=(8, 1)).astype(np.float32)
    got = attention.afm_attention(_t(w), _t(b), _t(h), _t(cross)).numpy()
    want = np.asarray(jax_attention.afm_attention(*map(jnp.asarray, (w, b, h, cross))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_catalog_scores_from_features_match_jax():
    """LR's catalog scores through each package's scorer: 70 users (a tile of
    64 and a ragged one) x 33 items."""
    rng = np.random.default_rng(6)
    nu, ni = 70, 33
    spec, jspec = FeatureSpec(num_users=nu, num_items=ni), JaxSpec(num_users=nu, num_items=ni)
    params = JaxLR(jspec).init(jax.random.PRNGKey(2))
    uf = np.concatenate([rng.random((nu, 1)), np.eye(2)[rng.integers(0, 2, nu)],
                         np.eye(21)[rng.integers(0, 21, nu)]], 1).astype(np.float32)
    itf = (rng.random((ni, 19)) < 0.2).astype(np.float32)
    want = jax_catalog_scores(JaxLR(jspec).apply, params, JaxCtx(jnp.asarray(uf), jnp.asarray(itf)))
    model = params_from_jax(LogisticRegression(spec, device="cpu"), jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = catalog_scores_from_features(model.apply_params, model.params(),
                                           ServingContext(_t(uf), _t(itf)))
    assert got.shape == (nu, ni)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
