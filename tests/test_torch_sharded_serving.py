"""The port's sharded serving (``parallel/serving.py``,
``serving.py::ShardedRecommender``) on Gloo ranks on the CPU, against the
JAX package's on a JAX mesh of the same model axis (the 8-device CPU mesh of
``tests/conftest.py``) and against the port's dense ``Recommender``.

One spawn a model-axis size (2 and 4, a module-scoped fixture, a deadline a
spawn) runs every case through ``tests/torch_ranks.py::serving_rank``; every
rank must return the same lists, and the lists must equal, id for id:

* ``sharded_topk`` against JAX's ``sharded_topk``, with and without ``seen``,
  on random factors and on integer-valued factors whose scores tie (the
  lowest id first), at a vocabulary the axis does not divide;
* ``sharded_feature_topk`` for DeepFM (its table substitution) against
  JAX's, with ``seen`` and a subset of users;
* ``ShardedRecommender`` for MF and DeepFM against the dense
  ``Recommender`` on the same params, its ``/v1/score`` answers too.

Each rank calls ``topk_serve_matmul`` once and ``topk_scores`` once a factored
query, and ``topk_scores`` twice a feature query (the block and the merge).
``sharded_catalog_topk`` raises for DIN and DIEN as the JAX function does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from deeplearningrecommendationsystem_tpu import parallel as jax_parallel
from deeplearningrecommendationsystem_tpu.features import FeatureSpec as JaxSpec
from deeplearningrecommendationsystem_tpu.models import DeepFM as JaxDeepFM
from deeplearningrecommendationsystem_tpu.models.base import ServingContext as JaxCtx
from deeplearningrecommendationsystem_tpu_torch.models import DIEN, DIN, ServingContext
from deeplearningrecommendationsystem_tpu_torch.parallel import sharded_catalog_topk
from deeplearningrecommendationsystem_tpu_torch.runtime.distributed import spawn
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender

import torch_ranks

DEADLINE_S = 120.0
U, I, D, K = 37, 203, 8, 11  # 203 items: the axis never divides the vocabulary
FM_KWARGS = {"hidden_units": (16, 8, 1), "embedding_dim": 8, "robust_init": True}
SCORE_USER, SCORE_ITEMS = 5, [0, 3, 77, I - 1]


def jax_mesh(model):
    return jax_parallel.make_mesh(data=1, model=model, devices=jax.devices()[:model])


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    P = rng.standard_normal((U, D)).astype(np.float32)
    Q = rng.standard_normal((I, D)).astype(np.float32)
    # integer factors in {-1, 0, 1}: scores are small integers, full of ties
    Pt = rng.integers(-1, 2, (U, 4)).astype(np.float32)
    Qt = rng.integers(-1, 2, (I, 4)).astype(np.float32)
    seen = rng.random((U, I)) < 0.15
    fm_model = JaxDeepFM(JaxSpec(num_users=U, num_items=I), **FM_KWARGS)
    fm_params = jax.tree.map(np.asarray, fm_model.init(jax.random.PRNGKey(5)))
    mf_params = {"user": P, "item": Q}
    uf = rng.random((U, 24)).astype(np.float32)
    itf = (rng.random((I, 19)) < 0.3).astype(np.float32)
    users = np.array([0, 9, 20, U - 1])
    return dict(P=P, Q=Q, Pt=Pt, Qt=Qt, seen=seen, fm_model=fm_model, fm_params=fm_params,
                mf_params=mf_params, uf=uf, itf=itf, users=users)


def _cases(x):
    feature = dict(kind="deepfm", U=U, I=I, kwargs=FM_KWARGS, params=x["fm_params"],
                   user_features=x["uf"], item_features=x["itf"], k=K)
    mf = dict(kind="mf", U=U, I=I, kwargs={"embedding_dim": D}, params=x["mf_params"],
              user_features=x["uf"], item_features=x["itf"], k=K)
    return [
        dict(name="topk", op="topk", P=x["P"], Q=x["Q"], k=K),
        dict(name="topk_seen", op="topk", P=x["P"], Q=x["Q"], k=K, seen=x["seen"]),
        dict(name="topk_ties", op="topk", P=x["Pt"], Q=x["Qt"], k=K),
        dict(name="feature", op="feature_topk", seen=x["seen"], users=x["users"], **feature),
        dict(name="rec_mf", op="recommender", seen=x["seen"], score_user=SCORE_USER,
             score_items=SCORE_ITEMS, **mf),
        dict(name="rec_deepfm", op="recommender", seen=x["seen"], users=x["users"],
             score_user=SCORE_USER, score_items=SCORE_ITEMS, **feature),
    ]


@pytest.fixture(scope="module", params=[2, 4], ids=["m2", "m4"])
def served(request, inputs):
    m = request.param
    out = spawn(torch_ranks.serving_rank, m, args=(_cases(inputs),), deadline_s=DEADLINE_S)
    return m, out


def _jax_topk(m, P, Q, seen=None):
    mesh = jax_mesh(m)
    Qs = jax_parallel.shard_table(jnp.asarray(Q), mesh)
    _, ids = jax_parallel.sharded_topk(jnp.asarray(P), Qs, mesh, Q.shape[0], K,
                                       seen=None if seen is None else jnp.asarray(seen))
    return np.asarray(ids)


def _same_on_every_rank(out, name):
    for o in out[1:]:
        np.testing.assert_array_equal(o[name]["ids"], out[0][name]["ids"])
        np.testing.assert_array_equal(o[name]["vals"], out[0][name]["vals"])
    return out[0][name]


@pytest.mark.parametrize("case", ["topk", "topk_seen", "topk_ties"])
def test_sharded_topk_matches_jax(served, inputs, case):
    m, out = served
    P, Q = (inputs["Pt"], inputs["Qt"]) if case == "topk_ties" else (inputs["P"], inputs["Q"])
    got = _same_on_every_rank(out, case)
    want = _jax_topk(m, P, Q, inputs["seen"] if case == "topk_seen" else None)
    np.testing.assert_array_equal(got["ids"], want)
    assert got["calls"] == {"gather_rows": 0, "onehot_grad": 0, "topk_serve_matmul": 1,
                            "topk_scores": 1}


def test_tied_scores_take_the_lowest_id_first(served, inputs):
    _, out = served
    got = out[0]["topk_ties"]
    scores = inputs["Pt"] @ inputs["Qt"].T
    order = np.lexsort((np.arange(I)[None, :].repeat(U, 0), -scores), axis=1)[:, :K]
    np.testing.assert_array_equal(got["ids"], order)


def test_sharded_feature_topk_matches_jax(served, inputs):
    m, out = served
    got = _same_on_every_rank(out, "feature")
    mesh = jax_mesh(m)
    params, _, _ = jax_parallel.shard_model_tables(
        jax.tree.map(jnp.asarray, inputs["fm_params"]), mesh)
    ctx = JaxCtx(user_features=jnp.asarray(inputs["uf"]), item_features=jnp.asarray(inputs["itf"]))
    _, want = jax_parallel.sharded_feature_topk(inputs["fm_model"], params, ctx, mesh, K,
                                                seen=jnp.asarray(inputs["seen"]),
                                                users=jnp.asarray(inputs["users"]))
    np.testing.assert_array_equal(got["ids"], np.asarray(want))
    # each user tile's forward looks up the four tables (every user row once
    # first, through the collective); one topk_scores for the block, one to merge
    assert got["calls"]["topk_scores"] == 2 and got["calls"]["topk_serve_matmul"] == 0


@pytest.mark.parametrize("kind", ["mf", "deepfm"])
def test_sharded_recommender_matches_dense(served, inputs, kind):
    _, out = served
    got = _same_on_every_rank(out, f"rec_{kind}")
    model = torch_ranks.build(kind, U, I, {"embedding_dim": D} if kind == "mf" else FM_KWARGS,
                              inputs["mf_params"] if kind == "mf" else inputs["fm_params"])
    ctx = ServingContext(user_features=torch.from_numpy(inputs["uf"]),
                         item_features=torch.from_numpy(inputs["itf"]))
    dense = Recommender(model, ctx, seen=inputs["seen"], use_pallas=False, device="cpu")
    users = None if kind == "mf" else inputs["users"]
    np.testing.assert_array_equal(got["ids"], dense.top_k(K, users))
    score = out[0][f"rec_{kind}:score"]
    for o in out[1:]:
        np.testing.assert_array_equal(o[f"rec_{kind}:score"], score)
    np.testing.assert_allclose(score, dense.score(SCORE_USER, SCORE_ITEMS), rtol=1e-6)


@pytest.mark.parametrize("cls", [DIN, DIEN])
def test_sharded_catalog_topk_rejects_sequence_models(cls):
    model = cls(I, embed_size=8, device="cpu")
    ctx = ServingContext(user_features=torch.zeros((U, 24)), item_features=torch.zeros((I, 19)))
    with pytest.raises(NotImplementedError, match="unshard"):
        sharded_catalog_topk(model, dict(model.named_parameters()), ctx, None, 5)
