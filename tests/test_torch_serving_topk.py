"""The port's serving top-k (plain versions, CPU) against the JAX package's
Pallas kernels in interpret mode and its XLA paths, on the same NumPy inputs.

Ids are compared exactly; values at atol=1e-5, since XLA's CPU dot and torch
sum in different orders (with integer-valued inputs both are exact). The JAX
Pallas kernel fills the slots of a user with fewer than k unseen items with
-1e30 and a repeated id, where a stable sort gives the lowest-indexed seen
items: against it, ids are compared only where the value is above -1e30 / 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.ops.pallas import serving_topk as jax_topk
from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as pt_topk

NEG_INF = -1e30


def _int_factors(rng, U, I, D):
    P = rng.integers(-3, 4, (U, D)).astype(np.float32)
    Q = rng.integers(-3, 4, (I, D)).astype(np.float32)
    return P, Q


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_against_pallas(got_v, got_i, want_v, want_i):
    got_v, got_i = got_v.numpy(), got_i.numpy()
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_allclose(got_v, want_v, atol=1e-5)
    live = want_v > NEG_INF / 2
    np.testing.assert_array_equal(got_i[live], want_i[live])


def _assert_exact(got_v, got_i, want_v, want_i):
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("k", [1, 7, 50, 128])
def test_topk_serve_matmul_matches_pallas_and_xla(k):
    rng = np.random.default_rng(10 + k)
    U, I, D = 37, 301, 16
    P, Q = _int_factors(rng, U, I, D)  # integer products: exact sums, many ties
    seen = rng.random((U, I)) < 0.3
    got_v, got_i = pt_topk.topk_serve_matmul(*_t(P, Q, seen), k=k)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    assert tuple(got_i.shape) == (U, k)
    want_v, want_i = jax_topk.topk_serve_matmul(
        jnp.asarray(P), jnp.asarray(Q), jnp.asarray(seen), k=k, tile=16, chunk=128,
        interpret=True)
    _assert_against_pallas(got_v, got_i, want_v, want_i)
    xla_v, xla_i = jax.lax.top_k(jnp.where(seen, NEG_INF, jnp.asarray(P) @ jnp.asarray(Q).T), k)
    _assert_exact(got_v, got_i, xla_v, xla_i)


@pytest.mark.parametrize("k", [1, 7, 50, 128])
def test_topk_scores_matches_pallas_with_ties(k):
    rng = np.random.default_rng(20 + k)
    U, I = 33, 400
    # quantised scores force ties; "+ 0.0" turns np.round's -0.0 into +0.0, which
    # lax.top_k ranks apart while the Pallas kernel and a stable sort tie them
    scores = (np.round(rng.normal(size=(U, I)) * 2) + 0.0).astype(np.float32)
    seen = rng.random((U, I)) < 0.2
    got_v, got_i = pt_topk.topk_scores(*_t(scores, seen), k=k)
    want_v, want_i = jax_topk.topk_scores_pallas(
        jnp.asarray(scores), jnp.asarray(seen), k=k, tile=16, chunk=128, interpret=True)
    _assert_against_pallas(got_v, got_i, want_v, want_i)
    xla_v, xla_i = jax.lax.top_k(jnp.where(seen, NEG_INF, jnp.asarray(scores)), k)
    _assert_exact(got_v, got_i, xla_v, xla_i)


@pytest.mark.parametrize("variant", ["matmul", "scores"])
def test_user_with_fewer_unseen_than_k(variant):
    """Slots past a user's unseen items: -1e30 and the lowest seen ids, as
    lax.top_k gives; the Pallas kernel agrees on every live slot."""
    rng = np.random.default_rng(4)
    U, I, D, k = 4, 300, 8, 10
    P, Q = _int_factors(rng, U, I, D)
    seen = rng.random((U, I)) < 0.2
    seen[0, :] = True
    seen[0, [5, 140, 290]] = False  # user 0 has 3 unseen items
    if variant == "matmul":
        got_v, got_i = pt_topk.topk_serve_matmul(*_t(P, Q, seen), k=k)
        want_v, want_i = jax_topk.topk_serve_matmul(
            jnp.asarray(P), jnp.asarray(Q), jnp.asarray(seen), k=k, tile=16, chunk=128,
            interpret=True)
        scores = jnp.asarray(P) @ jnp.asarray(Q).T
    else:
        scores = P @ Q.T
        got_v, got_i = pt_topk.topk_scores(*_t(scores, seen), k=k)
        want_v, want_i = jax_topk.topk_scores_pallas(
            jnp.asarray(scores), jnp.asarray(seen), k=k, tile=16, chunk=128, interpret=True)
    _assert_against_pallas(got_v, got_i, want_v, want_i)
    xla_v, xla_i = jax.lax.top_k(jnp.where(seen, NEG_INF, jnp.asarray(scores)), k)
    _assert_exact(got_v, got_i, xla_v, xla_i)
    assert sorted(got_i[0, :3].tolist()) == [5, 140, 290]
    assert got_i[0, 3:].tolist() == [0, 1, 2, 3, 4, 6, 7]
    assert (got_v[0, 3:] == NEG_INF).all()


@pytest.mark.parametrize("k", [10, 50])
def test_topk_two_stage_matches_jax(k):
    rng = np.random.default_rng(30 + k)
    U, I, D = 19, 1000, 8  # I is not a multiple of the group
    P, Q = _int_factors(rng, U, I, D)
    seen = rng.random((U, I)) < 0.1
    got_v, got_i = pt_topk.topk_two_stage(*_t(P, Q, seen), k=k)
    want_v, want_i = jax_topk.topk_two_stage(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(seen), k=k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))  # integer scores: exact
    # ids: the docstring lets the order of values tied at the k-th value depend on group rank;
    # both versions break ties the same way, and every id must carry its own score
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    masked = np.where(seen, NEG_INF, P @ Q.T)
    np.testing.assert_array_equal(np.take_along_axis(masked, got_i.numpy(), 1), got_v.numpy())
    full_v, _ = pt_topk.topk_serve_matmul_plain(*_t(P, Q, seen), k=k)
    np.testing.assert_array_equal(got_v.numpy(), full_v.numpy())


def test_stable_top_k_keeps_index_order():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    v, i = pt_topk.stable_top_k(x, 4)
    assert i.tolist() == [[1, 2, 4, 3]] and v.tolist() == [[3.0, 3.0, 3.0, 2.0]]


def test_wrappers_refuse_other_devices():
    P = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError):
        pt_topk.topk_serve_matmul(P, P, torch.zeros((4, 4), dtype=torch.bool, device="meta"), k=2)
    with pytest.raises(ValueError):  # mixed devices never reach the plain version
        pt_topk.topk_scores(torch.zeros((4, 8)), torch.zeros((4, 8), device="meta"), k=2)
