"""The port's MF serving slice against the JAX package's, on one synthetic
dataset, the same weights (carried across with ``params_from_jax``) and the
same seen mask of all three splits.

``Recommender.top_k`` lists must be equal, tie order included: the quantised
weights give exact integer-like scores with many ties. Scores compare at
atol=1e-5, since XLA's CPU dot and torch sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from deeplearningrecommendationsystem_tpu.data import MovieLens100K as JaxMovieLens
from deeplearningrecommendationsystem_tpu.models import MatrixFactorization as JaxMF
from deeplearningrecommendationsystem_tpu.models.base import ServingContext as JaxContext
from deeplearningrecommendationsystem_tpu.server import RecommenderServer as JaxServer
from deeplearningrecommendationsystem_tpu.serving import Recommender as JaxRecommender
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization, ServingContext
from deeplearningrecommendationsystem_tpu_torch.server import RecommenderServer
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

U, I, R, D = 60, 150, 3000, 64
ATOL = 1e-5


class CatalogOnly(nn.Module):
    """MF without ``serving_factors``: takes the non-factored top-k branch."""

    def __init__(self, model):
        super().__init__()
        self.inner = model

    def score_catalog(self, ctx):
        return self.inner.score_catalog(ctx)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    path = write_ml100k_format(str(tmp_path_factory.mktemp("ml")), seed=5,
                               num_users=U, num_items=I, num_ratings=R)
    return JaxMovieLens(path, seed=0, use_native=False), MovieLens100K(path, seed=0)


def _params(weights):
    params = {k: np.asarray(v) for k, v in JaxMF(U, I, D).init(jax.random.PRNGKey(0)).items()}
    if weights == "quantised":  # multiples of 1/16: exact sums, many tied scores
        params = {k: (np.round(v * 16) / 16).astype(np.float32) for k, v in params.items()}
    return params


def _build(datasets, weights, use_pallas=True, catalog_only=False):
    jx, pt = datasets
    params = _params(weights)
    seen = pt.seen_mask(pt.train, pt.valid, pt.test)
    jax_rec = JaxRecommender(
        JaxMF(U, I, D), {k: jnp.asarray(v) for k, v in params.items()},
        JaxContext(jnp.asarray(jx.user_features), jnp.asarray(jx.item_features)),
        seen=jx.seen_mask(jx.train, jx.valid, jx.test), use_pallas=False)
    model = params_from_jax(MatrixFactorization(U, I, D, device="cpu"), params)
    if catalog_only:
        model = CatalogOnly(model)
    ctx = ServingContext(torch.from_numpy(pt.user_features), torch.from_numpy(pt.item_features))
    return jax_rec, Recommender(model, ctx, seen=seen, use_pallas=use_pallas, device="cpu")


@pytest.fixture(scope="module", params=["xavier", "quantised"])
def pair(request, datasets):
    return _build(datasets, request.param)


def test_params_from_jax_copies_weights(datasets):
    params = _params("xavier")
    model = params_from_jax(MatrixFactorization(U, I, D, device="cpu"), params)
    np.testing.assert_array_equal(model.user.detach().numpy(), params["user"])
    np.testing.assert_array_equal(model.item.detach().numpy(), params["item"])
    users, items = np.array([0, 3, 59]), np.array([1, 149, 7])
    want = JaxMF(U, I, D).apply({k: jnp.asarray(v) for k, v in params.items()},
                                (jnp.asarray(users), jnp.asarray(items)))
    got = model(torch.from_numpy(users), torch.from_numpy(items))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError):
        params_from_jax(MatrixFactorization(U + 1, I, D, device="cpu"), params)


@pytest.mark.parametrize("k", [1, 10, 50, 128, 150])
def test_top_k_matches_jax(pair, k):
    """k <= 128 takes the fused top-k, k > 128 the plain stable sort."""
    jax_rec, rec = pair
    got, want = rec.top_k(k), jax_rec.top_k(k)
    assert got.dtype == np.int32 and got.shape == (U, k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_pallas", [False, "fused"])
@pytest.mark.parametrize("catalog_only", [False, True], ids=["factored", "non_factored"])
def test_top_k_every_policy_matches_jax(datasets, use_pallas, catalog_only):
    jax_rec, rec = _build(datasets, "quantised", use_pallas, catalog_only)
    for k in (7, 50):
        np.testing.assert_array_equal(rec.top_k(k), jax_rec.top_k(k))
        users = [4, 0, 4, 33]
        np.testing.assert_array_equal(rec.top_k(k, users), jax_rec.top_k(k, users))


def test_top_k_users_subset(pair):
    jax_rec, rec = pair
    users = [3, 0, 59, 17, 3]
    np.testing.assert_array_equal(rec.top_k(20, users), jax_rec.top_k(20, users))


@pytest.mark.parametrize("users", [None, [8, 2, 41]])
def test_top_k_with_scores(pair, users):
    jax_rec, rec = pair
    got_i, got_s = rec.top_k_with_scores(30, users)
    want_i, want_s = jax_rec.top_k_with_scores(30, users)
    np.testing.assert_array_equal(got_i, want_i)
    assert got_s.dtype == np.float32
    np.testing.assert_allclose(got_s, want_s, atol=ATOL)


def test_score(pair, datasets):
    jax_rec, rec = pair
    seen_items = datasets[1].train["item"][datasets[1].train["user"] == 5][:3].tolist()
    items = [0, 7, 149] + seen_items
    got, want = rec.score(5, items), jax_rec.score(5, items)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert (got[3:] < -1e29).all()  # seen items carry the mask value
    assert rec.shape == jax_rec.shape == (U, I)


ROUTES = [
    ("GET", "/healthz", {}),
    ("GET", "/v1/recommend?user=12&k=10", {}),
    ("GET", "/v1/recommend?user=59", {}),
    ("GET", "/v1/recommend", {}),
    ("POST", "/v1/recommend", {"users": [0, 5, 59], "k": 50}),
    ("POST", "/v1/recommend", {"users": [1], "k": 1000}),  # k clipped to the catalog
    ("POST", "/v1/recommend", {"users": []}),
    ("POST", "/v1/score", {"user": 3, "items": [0, 1, 2, 149]}),
    ("POST", "/v1/score", {"items": [1]}),
    ("POST", "/v1/refresh", {}),
    ("GET", "/nowhere", {}),
]


def _assert_payloads_match(got, want, key=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (got, want)
        for k in want:
            _assert_payloads_match(got[k], want[k], k)
    elif key == "scores":
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL)
    else:
        assert got == want


@pytest.fixture(scope="module")
def servers(pair):
    jax_rec, rec = pair
    both = JaxServer(jax_rec), RecommenderServer(rec)
    yield both
    for s in both:
        s.httpd.server_close()


@pytest.mark.parametrize("method,path,body", ROUTES, ids=[f"{m} {p}" for m, p, _ in ROUTES])
def test_dispatch_payloads_match_jax(servers, method, path, body):
    jax_server, server = servers
    want_code, want = jax_server.dispatch(method, path, body)
    got_code, got = server.dispatch(method, path, body)
    assert got_code == want_code
    _assert_payloads_match(got, want)


def test_dispatch_rejects_unknown_user(servers):
    for s in servers:
        with pytest.raises(ValueError):
            s.dispatch("POST", "/v1/recommend", {"users": [U]})
